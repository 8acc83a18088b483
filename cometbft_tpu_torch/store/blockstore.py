"""BlockStore: canonical chain persistence (the port's copy of
`cometbft_tpu.store.blockstore`; CometBFT store/store.go).

Blocks are stored exploded — meta (header + block id + size) under the
height key, each 64 KiB part under (height, index), commits separately —
so gossip can serve single parts and light clients single commits
without loading whole blocks (store/store.go:586 SaveBlock layout).

Key layout uses fixed-width big-endian heights so lexicographic KV order
== height order (reference store/db_key_layout.go v2 ordered-code idea):

  b"H:" + be64(height)              -> BlockMeta proto
  b"P:" + be64(height) + be32(idx)  -> Part proto
  b"C:" + be64(height)              -> Commit proto   (height's LastCommit)
  b"SC:" + be64(height)             -> Commit proto   (seen commit)
  b"EC:" + be64(height)             -> ExtendedCommit proto
  b"BH:" + block_hash               -> be64(height)
  b"blockStore"                     -> BlockStoreState (base, height)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..libs import lockrank
from ..libs import protowire as pw
from ..types.block import Block, BlockID, Commit, Header, PartSetHeader
from ..types.part_set import Part, PartSet, SerializedBlockCache
from .kv import KVStore, be64


def _k_meta(h: int) -> bytes:
    return b"H:" + be64(h)


def _k_part(h: int, i: int) -> bytes:
    return b"P:" + be64(h) + struct.pack(">I", i)


def _k_commit(h: int) -> bytes:
    return b"C:" + be64(h)


def _k_seen_commit(h: int) -> bytes:
    return b"SC:" + be64(h)


def _k_ext_commit(h: int) -> bytes:
    return b"EC:" + be64(h)


def _k_hash(block_hash: bytes) -> bytes:
    return b"BH:" + block_hash


_K_STATE = b"blockStore"


@dataclass
class BlockMeta:
    """types/block_meta.go analog."""
    block_id: BlockID
    block_size: int
    header: Header
    num_txs: int

    def to_proto(self) -> bytes:
        return (pw.Writer()
                .message_field(1, self.block_id.to_proto())
                .int_field(2, self.block_size)
                .message_field(3, self.header.to_proto())
                .int_field(4, self.num_txs).bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "BlockMeta":
        r = pw.Reader(payload)
        bid, size, hdr, ntx = BlockID(), 0, None, 0
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                bid = BlockID.from_proto(r.read_bytes())
            elif f == 2 and w == pw.VARINT:
                size = r.read_int()
            elif f == 3 and w == pw.BYTES:
                hdr = Header.from_proto(r.read_bytes())
            elif f == 4 and w == pw.VARINT:
                ntx = r.read_int()
            else:
                r.skip(w)
        return BlockMeta(bid, size, hdr, ntx)


class BlockStore:
    """store.BlockStore analog; all heights are inclusive [base, height]."""

    def __init__(self, db: KVStore):
        self._db = db
        self._mtx = lockrank.RankedRLock("store.blockstore")
        self._base = 0
        self._height = 0
        # encode-once serve-many (types/part_set.SerializedBlockCache):
        # save_block deposits the wire bytes it already built; block /
        # part loads serve from it without decode + re-encode
        self._block_cache = SerializedBlockCache()
        raw = db.get(_K_STATE)
        if raw is not None:
            r = pw.Reader(raw)
            while not r.at_end():
                f, w = r.read_tag()
                if f == 1 and w == pw.VARINT:
                    self._base = r.read_int()
                elif f == 2 and w == pw.VARINT:
                    self._height = r.read_int()
                else:
                    r.skip(w)

    # -- extent ------------------------------------------------------------

    def base(self) -> int:
        with self._mtx:
            return self._base

    def height(self) -> int:
        with self._mtx:
            return self._height

    def size(self) -> int:
        with self._mtx:
            return self._height - self._base + 1 if self._height else 0

    def _state_bytes(self) -> bytes:
        return (pw.Writer().int_field(1, self._base)
                .int_field(2, self._height).bytes())

    # -- save --------------------------------------------------------------

    def save_block(self, block: Block, parts: PartSet,
                   seen_commit: Commit | None,
                   ext_commit: bytes | None = None) -> None:
        """store/store.go:586 SaveBlock / :618 SaveBlockWithExtendedCommit:
        meta + parts + LastCommit + seen commit + hash index + extent —
        and, when vote extensions are enabled, the extended commit — in
        ONE atomic batch, so a crash can never leave a committed block
        without the extended commit its restart replay needs."""
        if block is None:
            raise ValueError("BlockStore can only save a non-nil block")
        height = block.header.height
        with self._mtx:
            expected = self._height + 1 if self._height else height
            if self._height and height != expected:
                raise ValueError(
                    f"BlockStore can only save contiguous blocks: wanted "
                    f"{expected}, got {height}")
            if not parts.is_complete():
                raise ValueError(
                    "BlockStore can only save complete part sets")
            block_id = BlockID(block.hash(), parts.header)
            meta = BlockMeta(block_id=block_id, block_size=parts.byte_size,
                             header=block.header,
                             num_txs=len(block.data.txs))
            sets = [(_k_meta(height), meta.to_proto()),
                    (_k_hash(block.hash()), be64(height))]
            part_protos = []
            for i in range(parts.header.total):
                p = parts.get_part(i).to_proto()
                part_protos.append(p)
                sets.append((_k_part(height, i), p))
            # height's LastCommit == commit *for* height-1
            if block.last_commit is not None:
                sets.append((_k_commit(height - 1),
                             block.last_commit.to_proto()))
            if seen_commit is not None:
                sets.append((_k_seen_commit(height),
                             seen_commit.to_proto()))
            if ext_commit is not None:
                sets.append((_k_ext_commit(height), ext_commit))
            self._height = height
            if self._base == 0:
                self._base = height
            sets.append((_K_STATE, self._state_bytes()))
            self._db.write_batch(sets)
            # the joined part chunks ARE the serialized block: deposit
            # both forms so later serves skip decode + re-encode
            self._block_cache.put(height, parts.assemble(), part_protos)

    def save_seen_commit(self, height: int, commit: Commit) -> None:
        self._db.set(_k_seen_commit(height), commit.to_proto())

    def save_extended_commit(self, height: int, ext: bytes) -> None:
        """Extended commit stored as opaque proto bytes (vote extensions)."""
        self._db.set(_k_ext_commit(height), ext)

    # -- load --------------------------------------------------------------

    def load_block_meta(self, height: int) -> BlockMeta | None:
        raw = self._db.get(_k_meta(height))
        return BlockMeta.from_proto(raw) if raw is not None else None

    def load_block_meta_by_hash(self, block_hash: bytes) -> BlockMeta | None:
        raw = self._db.get(_k_hash(block_hash))
        if raw is None:
            return None
        return self.load_block_meta(struct.unpack(">Q", raw)[0])

    def load_block_bytes(self, height: int) -> bytes | None:
        """Serialized block wire bytes for `height`: the encode-once
        cached form when present, else joined from the stored parts
        (and deposited for the next reader).  The blocksync serve path
        ships these bytes directly — a cache hit costs no proto
        decode, no re-encode, and no part split."""
        cached = self._block_cache.get_block_bytes(height)
        if cached is not None:
            return cached
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        buf, part_protos = [], []
        for i in range(meta.block_id.part_set_header.total):
            raw = self._db.get(_k_part(height, i))
            if raw is None:
                return None
            part_protos.append(raw)
            buf.append(Part.from_proto(raw).bytes_)
        data = b"".join(buf)
        self._block_cache.put(height, data, part_protos)
        return data

    def load_block(self, height: int) -> Block | None:
        """Reassemble from parts (store/store.go:222 LoadBlock)."""
        raw = self.load_block_bytes(height)
        return Block.from_proto(raw) if raw is not None else None

    def load_block_by_hash(self, block_hash: bytes) -> Block | None:
        raw = self._db.get(_k_hash(block_hash))
        if raw is None:
            return None
        return self.load_block(struct.unpack(">Q", raw)[0])

    def load_block_part(self, height: int, index: int) -> Part | None:
        cached = self._block_cache.get_part_proto(height, index)
        if cached is not None:
            return Part.from_proto(cached)
        raw = self._db.get(_k_part(height, index))
        return Part.from_proto(raw) if raw is not None else None

    def load_block_commit(self, height: int) -> Commit | None:
        """The canonical commit FOR `height` (from block height+1's
        LastCommit; store/store.go:372)."""
        raw = self._db.get(_k_commit(height))
        return Commit.from_proto(raw) if raw is not None else None

    def load_seen_commit(self, height: int) -> Commit | None:
        raw = self._db.get(_k_seen_commit(height))
        return Commit.from_proto(raw) if raw is not None else None

    def load_extended_commit(self, height: int) -> bytes | None:
        return self._db.get(_k_ext_commit(height))

    # -- prune -------------------------------------------------------------

    def delete_latest_block(self) -> None:
        """Remove the highest block (store/store.go DeleteLatestBlock) —
        the rollback --hard path."""
        with self._mtx:
            h = self._height
            if h < self._base or h == 0:
                raise ValueError("no block to delete")
            meta = self.load_block_meta(h)
            deletes = [_k_seen_commit(h), _k_ext_commit(h), _k_commit(h)]
            if meta is not None:
                deletes.append(_k_meta(h))
                deletes.append(_k_hash(meta.block_id.hash))
                for i in range(meta.block_id.part_set_header.total):
                    deletes.append(_k_part(h, i))
            self._height = h - 1
            self._db.write_batch([(_K_STATE, self._state_bytes())], deletes)
            self._block_cache.invalidate(h)

    def prune_blocks(self, retain_height: int) -> int:
        """Remove blocks below retain_height; keep the commit for
        retain_height-1 (needed to verify retain_height). Returns the
        number of blocks pruned (store/store.go:474)."""
        with self._mtx:
            if retain_height <= self._base:
                return 0
            if retain_height > self._height + 1:
                raise ValueError(
                    f"cannot prune beyond store height {self._height}")
            pruned = 0
            deletes: list[bytes] = []
            for h in range(self._base, retain_height):
                meta = self.load_block_meta(h)
                if meta is None:
                    continue
                deletes.append(_k_meta(h))
                deletes.append(_k_hash(meta.block_id.hash))
                for i in range(meta.block_id.part_set_header.total):
                    deletes.append(_k_part(h, i))
                if h < retain_height - 1:
                    deletes.append(_k_commit(h))
                deletes.append(_k_seen_commit(h))
                deletes.append(_k_ext_commit(h))
                pruned += 1
            self._base = retain_height
            self._db.write_batch([(_K_STATE, self._state_bytes())], deletes)
            self._block_cache.invalidate_below(retain_height)
            return pruned
