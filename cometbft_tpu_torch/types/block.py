"""BlockID, CommitSig, Commit, ExtendedCommitSig and ExtendedCommit with
their proto codecs (the port's copy of the parts of
`cometbft_tpu.types.block` that commit verification and the vote path
read; Header, Data and Block are not ported).

Proto layouts follow CometBFT proto/cometbft/types/v1/types.proto; the
class and field names match the JAX package's, so the error messages
that print a BlockID are byte-identical between the two.  Commit.hash
is the Merkle root over the CommitSig protos (CometBFT block.go:964).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

from ..crypto import merkle
from ..libs import protowire as pw
from .timestamp import Timestamp

BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3


class BlockIDFlag(IntEnum):
    ABSENT = 1
    COMMIT = 2
    NIL = 3


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and not self.hash

    def to_proto(self) -> bytes:
        return (pw.Writer().uvarint_field(1, self.total)
                .bytes_field(2, self.hash).bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "PartSetHeader":
        r = pw.Reader(payload)
        total, h = 0, b""
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                total = r.read_uvarint()
            elif f == 2 and w == pw.BYTES:
                h = r.read_bytes()
            else:
                r.skip(w)
        return PartSetHeader(total, h)


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_nil(self) -> bool:
        """IsNil in CometBFT: the zero BlockID."""
        return not self.hash and self.part_set_header.is_zero()

    def is_complete(self) -> bool:
        return (len(self.hash) == 32 and self.part_set_header.total > 0
                and len(self.part_set_header.hash) == 32)

    def key(self) -> bytes:
        """The map key of CometBFT's BlockID.Key: hash, part-set hash,
        then the part total as four big-endian bytes."""
        return self.hash + self.part_set_header.hash + \
            self.part_set_header.total.to_bytes(4, "big")

    def to_proto(self) -> bytes:
        # part_set_header is nullable=false: always emitted
        return (pw.Writer().bytes_field(1, self.hash)
                .message_field(2, self.part_set_header.to_proto()).bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "BlockID":
        r = pw.Reader(payload)
        h, psh = b"", PartSetHeader()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                h = r.read_bytes()
            elif f == 2 and w == pw.BYTES:
                psh = PartSetHeader.from_proto(r.read_bytes())
            else:
                r.skip(w)
        return BlockID(h, psh)


@dataclass(frozen=True)
class CommitSig:
    """One validator's precommit inside a Commit."""

    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp: Timestamp = field(default_factory=Timestamp.zero)
    signature: bytes = b""

    @staticmethod
    def absent() -> "CommitSig":
        return CommitSig()

    def for_block(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_COMMIT

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """The BlockID this sig signed over (block.go:640-653)."""
        if self.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            return commit_block_id
        return BlockID()

    def validate_basic(self) -> None:
        if self.block_id_flag == BLOCK_ID_FLAG_ABSENT:
            if self.validator_address or self.signature \
                    or not self.timestamp.is_zero():
                raise ValueError("absent CommitSig must be empty")
            return
        if self.block_id_flag not in (BLOCK_ID_FLAG_COMMIT,
                                      BLOCK_ID_FLAG_NIL):
            raise ValueError(f"unknown BlockIDFlag {self.block_id_flag}")
        if len(self.validator_address) != 20:
            raise ValueError("expected 20-byte validator address")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > 64:
            raise ValueError("signature too big")

    def to_proto(self) -> bytes:
        # the flag is masked as Writer.int_field masks it: a decoded
        # negative flag re-encodes to the same 10-byte form
        return (pw.Writer().int_field(1, self.block_id_flag)
                .bytes_field(2, self.validator_address)
                .message_field(3, self.timestamp.to_proto())
                .bytes_field(4, self.signature).bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "CommitSig":
        r = pw.Reader(payload)
        flag, addr, ts, sig = 0, b"", Timestamp.zero(), b""
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                flag = r.read_int()
            elif f == 2 and w == pw.BYTES:
                addr = r.read_bytes()
            elif f == 3 and w == pw.BYTES:
                ts = Timestamp.from_proto(r.read_bytes())
            elif f == 4 and w == pw.BYTES:
                sig = r.read_bytes()
            else:
                r.skip(w)
        return CommitSig(flag, addr, ts, sig)


@dataclass
class Commit:
    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    signatures: list[CommitSig] = field(default_factory=list)

    def size(self) -> int:
        return len(self.signatures)

    def vote_sign_bytes_all(self, chain_id: str) -> list[bytes]:
        """Canonical sign-bytes for EVERY precommit of this commit, in
        signature order: signatures split into the two canonical-vote
        shapes (commit BlockID vs nil) and each group is assembled by one
        columnar splice (canonical.vote_sign_bytes_columnar).  Memoized
        per (chain_id, height, round, block_id)."""
        key = (chain_id, self.height, self.round, self.block_id)
        memo = getattr(self, "_sb_all", None)
        if memo is not None and memo[0] == key:
            return memo[1]
        from . import canonical
        sigs = self.signatures
        out: list[bytes] = [b""] * len(sigs)
        for for_block in (True, False):
            idx = [i for i, s in enumerate(sigs)
                   if (s.block_id_flag == BLOCK_ID_FLAG_COMMIT) == for_block]
            if not idx:
                continue
            rows = canonical.vote_sign_bytes_columnar(
                chain_id, canonical.PRECOMMIT, self.height, self.round,
                self.block_id if for_block else BlockID(),
                [sigs[i].timestamp for i in idx])
            for i, sb in zip(idx, rows):
                out[i] = sb
        self._sb_all = (key, out)
        return out

    def vote_sign_bytes(self, chain_id: str, val_idx: int) -> bytes:
        """Canonical sign-bytes for validator val_idx's precommit."""
        return self.vote_sign_bytes_all(chain_id)[val_idx]

    def hash(self) -> bytes:
        """Merkle root over the CommitSig protos, on the host."""
        return merkle.hash_from_byte_slices(
            [s.to_proto() for s in self.signatures])

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.height >= 1:
            if self.block_id.is_nil():
                raise ValueError("commit cannot be for nil block")
            if not self.signatures:
                raise ValueError("no signatures in commit")
            for sig in self.signatures:
                sig.validate_basic()

    def to_proto(self) -> bytes:
        w = (pw.Writer().int_field(1, self.height)
             .int_field(2, self.round)
             .message_field(3, self.block_id.to_proto()))
        for sig in self.signatures:
            w.message_field(4, sig.to_proto())
        return w.bytes()

    @staticmethod
    def from_proto(payload: bytes) -> "Commit":
        r = pw.Reader(payload)
        c = Commit()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                c.height = r.read_int()
            elif f == 2 and w == pw.VARINT:
                c.round = r.read_int()
            elif f == 3 and w == pw.BYTES:
                c.block_id = BlockID.from_proto(r.read_bytes())
            elif f == 4 and w == pw.BYTES:
                c.signatures.append(CommitSig.from_proto(r.read_bytes()))
            else:
                r.skip(w)
        return c


@dataclass(frozen=True)
class ExtendedCommitSig:
    """CommitSig + vote-extension data (block.go:724)."""

    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp: Timestamp = field(default_factory=Timestamp.zero)
    signature: bytes = b""
    extension: bytes = b""
    extension_signature: bytes = b""

    @staticmethod
    def absent() -> "ExtendedCommitSig":
        return ExtendedCommitSig()

    def for_block(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_COMMIT

    def to_commit_sig(self) -> CommitSig:
        return CommitSig(self.block_id_flag, self.validator_address,
                         self.timestamp, self.signature)

    def validate_basic(self) -> None:
        self.to_commit_sig().validate_basic()
        if self.block_id_flag != BLOCK_ID_FLAG_COMMIT and (
                self.extension or self.extension_signature):
            raise ValueError(
                "non-commit sig must not carry a vote extension")
        if len(self.extension_signature) > 64:
            raise ValueError("extension signature too big")

    def ensure_extension(self, ext_enabled: bool) -> None:
        """block.go:773: extensions required exactly when enabled."""
        has = bool(self.extension_signature)
        if ext_enabled and self.for_block() and not has:
            raise ValueError("vote extension data missing")
        if not ext_enabled and (self.extension or self.extension_signature):
            raise ValueError("unexpected vote extension data")

    def to_proto(self) -> bytes:
        return (pw.Writer().int_field(1, self.block_id_flag)
                .bytes_field(2, self.validator_address)
                .message_field(3, self.timestamp.to_proto())
                .bytes_field(4, self.signature)
                .bytes_field(5, self.extension)
                .bytes_field(6, self.extension_signature).bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "ExtendedCommitSig":
        r = pw.Reader(payload)
        vals = {"block_id_flag": 0, "validator_address": b"",
                "timestamp": Timestamp.zero(), "signature": b"",
                "extension": b"", "extension_signature": b""}
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                vals["block_id_flag"] = r.read_int()
            elif f == 2 and w == pw.BYTES:
                vals["validator_address"] = r.read_bytes()
            elif f == 3 and w == pw.BYTES:
                vals["timestamp"] = Timestamp.from_proto(r.read_bytes())
            elif f == 4 and w == pw.BYTES:
                vals["signature"] = r.read_bytes()
            elif f == 5 and w == pw.BYTES:
                vals["extension"] = r.read_bytes()
            elif f == 6 and w == pw.BYTES:
                vals["extension_signature"] = r.read_bytes()
            else:
                r.skip(w)
        return ExtendedCommitSig(**vals)


@dataclass
class ExtendedCommit:
    """Commit carrying vote extensions, persisted alongside blocks when
    extensions are enabled (block.go:1081)."""

    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    extended_signatures: list[ExtendedCommitSig] = field(
        default_factory=list)

    def size(self) -> int:
        return len(self.extended_signatures)

    def to_commit(self) -> Commit:
        return Commit(self.height, self.round, self.block_id,
                      [s.to_commit_sig()
                       for s in self.extended_signatures])

    def ensure_extensions(self, ext_enabled: bool) -> None:
        for s in self.extended_signatures:
            s.ensure_extension(ext_enabled)

    def bit_array(self):
        from ..libs.bits import BitArray
        return BitArray.from_bools(
            [bool(s.signature) for s in self.extended_signatures])

    def validate_basic(self) -> None:
        if self.height < 0 or self.round < 0:
            raise ValueError("negative height/round")
        if self.height >= 1:
            if self.block_id.is_nil():
                raise ValueError("extended commit cannot be for nil block")
            if not self.extended_signatures:
                raise ValueError("no signatures in extended commit")
            for s in self.extended_signatures:
                s.validate_basic()

    def to_proto(self) -> bytes:
        w = (pw.Writer().int_field(1, self.height)
             .int_field(2, self.round)
             .message_field(3, self.block_id.to_proto()))
        for s in self.extended_signatures:
            w.message_field(4, s.to_proto())
        return w.bytes()

    @staticmethod
    def from_proto(payload: bytes) -> "ExtendedCommit":
        r = pw.Reader(payload)
        ec = ExtendedCommit()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                ec.height = r.read_int()
            elif f == 2 and w == pw.VARINT:
                ec.round = r.read_int()
            elif f == 3 and w == pw.BYTES:
                ec.block_id = BlockID.from_proto(r.read_bytes())
            elif f == 4 and w == pw.BYTES:
                ec.extended_signatures.append(
                    ExtendedCommitSig.from_proto(r.read_bytes()))
            else:
                r.skip(w)
        return ec
