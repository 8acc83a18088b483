"""Block part sets: serialized block -> fixed-size parts + Merkle proofs
(the port's copy of `cometbft_tpu.types.part_set`; CometBFT
types/part_set.go:25 Part, :162 PartSet).

A block's proto bytes are split into BLOCK_PART_SIZE chunks, the
PartSetHeader commits to the Merkle root over the chunks, and each Part
carries an inclusion proof so parts can be gossiped and verified
independently.  All of it hashes on the host (a block is a few parts).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

from ..crypto import merkle
from ..libs import lockrank
from ..libs import protowire as pw
from .block import PartSetHeader

BLOCK_PART_SIZE = 65536  # reference types/part_set.go:25 BlockPartSizeBytes


class PartSetError(Exception):
    pass


@dataclass
class Part:
    index: int
    bytes_: bytes
    proof: merkle.Proof

    def validate_basic(self) -> None:
        if self.index < 0:
            raise PartSetError("negative part index")
        if len(self.bytes_) > BLOCK_PART_SIZE:
            raise PartSetError("part too big")
        if self.proof.index != self.index:
            raise PartSetError("proof index mismatch")

    def to_proto(self) -> bytes:
        return (pw.Writer().uvarint_field(1, self.index)
                .bytes_field(2, self.bytes_)
                .message_field(3, self.proof.to_proto()).bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "Part":
        r = pw.Reader(payload)
        index, data, proof = 0, b"", None
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                index = r.read_uvarint()
            elif f == 2 and w == pw.BYTES:
                data = r.read_bytes()
            elif f == 3 and w == pw.BYTES:
                proof = merkle.Proof.from_proto(r.read_bytes())
            else:
                r.skip(w)
        if proof is None:
            raise PartSetError("part missing proof")
        return Part(index=index, bytes_=data, proof=proof)


@dataclass
class PartSet:
    header: PartSetHeader
    parts: list = field(default_factory=list)  # list[Part | None]
    count: int = 0
    byte_size: int = 0

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_data(data: bytes, part_size: int = BLOCK_PART_SIZE) -> "PartSet":
        """Split serialized block into parts (types/part_set.go:162)."""
        total = max(1, (len(data) + part_size - 1) // part_size)
        chunks = [data[i * part_size:(i + 1) * part_size]
                  for i in range(total)]
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        parts = [Part(index=i, bytes_=chunks[i], proof=proofs[i])
                 for i in range(total)]
        return PartSet(
            header=PartSetHeader(total=total, hash=root),
            parts=list(parts), count=total, byte_size=len(data))

    @staticmethod
    def new_from_header(header: PartSetHeader) -> "PartSet":
        return PartSet(header=header, parts=[None] * header.total,
                       count=0, byte_size=0)

    # -- assembly ----------------------------------------------------------

    def add_part(self, part: Part) -> bool:
        """Verify the part's proof against our header and slot it in.

        Returns False (no-op) for duplicates; raises PartSetError on
        invalid proofs (reference part_set.go AddPart).
        """
        if part.index >= self.header.total:
            raise PartSetError("unexpected part index %d >= total %d"
                               % (part.index, self.header.total))
        if self.parts[part.index] is not None:
            return False
        part.validate_basic()
        if part.proof.total != self.header.total:
            raise PartSetError("proof total mismatch")
        try:
            part.proof.verify(self.header.hash, part.bytes_)
        except ValueError as e:
            raise PartSetError(f"invalid part proof: {e}") from e
        self.parts[part.index] = part
        self.count += 1
        self.byte_size += len(part.bytes_)
        return True

    def get_part(self, index: int):
        return self.parts[index] if 0 <= index < len(self.parts) else None

    def is_complete(self) -> bool:
        return self.count == self.header.total

    def assemble(self) -> bytes:
        if not self.is_complete():
            raise PartSetError("incomplete part set %d/%d"
                               % (self.count, self.header.total))
        return b"".join(p.bytes_ for p in self.parts)

    def bit_array(self) -> list[bool]:
        return [p is not None for p in self.parts]


class SerializedBlockCache:
    """Encode-once, serve-many: a bounded LRU of height -> (block wire
    bytes, per-part proto bytes).

    save_block already holds both forms — the joined part chunks ARE
    the serialized block, and each part proto was just built for the KV
    batch — so caching them kills the partset residual on the serve
    side: a blocksync BlockResponse ships the cached wire bytes without
    decode + re-encode + re-split, and a consensus gossip part request
    ships the cached part proto without a KV read.  Bounded
    (`capacity` heights, DEFAULT_CAPACITY unless given; 0 disables) and
    thread safe; hit/miss/eviction counts are plain ints."""

    DEFAULT_CAPACITY = 64

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(0, int(capacity))
        self._mtx = lockrank.RankedLock("part_set.block_cache")
        # height -> (block_bytes, tuple[part proto bytes, ...])
        self._entries: OrderedDict[int, tuple] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._mtx:
            return len(self._entries)

    def put(self, height: int, block_bytes: bytes, part_protos) -> None:
        if self.capacity == 0:
            return
        with self._mtx:
            self._entries[height] = (bytes(block_bytes),
                                     tuple(part_protos))
            self._entries.move_to_end(height)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1

    def _lookup(self, height: int):
        with self._mtx:
            entry = self._entries.get(height)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(height)
            self.hits += 1
            return entry

    def get_block_bytes(self, height: int) -> bytes | None:
        entry = self._lookup(height)
        return entry[0] if entry is not None else None

    def get_part_proto(self, height: int, index: int) -> bytes | None:
        entry = self._lookup(height)
        if entry is None or not 0 <= index < len(entry[1]):
            return None
        return entry[1][index]

    def invalidate(self, height: int) -> bool:
        with self._mtx:
            if self._entries.pop(height, None) is None:
                return False
            self.evictions += 1
            return True

    def invalidate_below(self, retain_height: int) -> int:
        with self._mtx:
            stale = [h for h in self._entries if h < retain_height]
            for h in stale:
                del self._entries[h]
            self.evictions += len(stale)
            return len(stale)
