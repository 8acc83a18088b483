"""Block, Header, Data, Commit and friends with their proto codecs (the
port's copy of `cometbft_tpu.types.block`; CometBFT types/block.go).

Proto layouts follow CometBFT proto/cometbft/types/v1/types.proto; the
class and field names match the JAX package's, so the error messages
that print a BlockID are byte-identical between the two.  Hashes follow
CometBFT: Header.hash is the Merkle root over its 14 proto-encoded
fields, Commit.hash over the CommitSig protos, Data.hash over the
transactions' SHA-256, the evidence hash over each item's proto bytes.
All of them are small trees hashed on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

from ..crypto import merkle
from ..crypto.hash import sum_sha256
from ..libs import protowire as pw
from .timestamp import Timestamp

MAX_HEADER_BYTES = 626
BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3


class BlockIDFlag(IntEnum):
    ABSENT = 1
    COMMIT = 2
    NIL = 3


def _cdc_bytes(v: bytes) -> bytes:
    """cdcEncode of bytes: a BytesValue wrapper, nothing when empty
    (CometBFT types/encoding_helper.go)."""
    if not v:
        return b""
    return pw.Writer().bytes_field(1, v).bytes()


def _cdc_string(v: str) -> bytes:
    if not v:
        return b""
    return pw.Writer().string_field(1, v).bytes()


def _cdc_int64(v: int) -> bytes:
    if v == 0:
        return b""
    return pw.Writer().int_field(1, v).bytes()


@dataclass(frozen=True)
class Consensus:
    """Version info (proto/cometbft/version/v1/types.proto)."""

    block: int = 11        # BlockProtocol, version/version.go
    app: int = 0

    def to_proto(self) -> bytes:
        return (pw.Writer().uvarint_field(1, self.block)
                .uvarint_field(2, self.app).bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "Consensus":
        r = pw.Reader(payload)
        block = app = 0
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                block = r.read_uvarint()
            elif f == 2 and w == pw.VARINT:
                app = r.read_uvarint()
            else:
                r.skip(w)
        return Consensus(block, app)


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

    def median_time(self, validators) -> Timestamp:
        """The voting-power-weighted median of the precommit timestamps:
        BFT time (block.go, types/time/time.go WeightedMedian)."""
        weighted = []  # (unix_ns, power)
        total_power = 0
        for cs in self.signatures:
            if cs.block_id_flag == BLOCK_ID_FLAG_ABSENT:
                continue
            _, val = validators.get_by_address(cs.validator_address)
            if val is not None:
                total_power += val.voting_power
                weighted.append(
                    (cs.timestamp.seconds * 1_000_000_000
                     + cs.timestamp.nanos, val.voting_power))
        weighted.sort(key=lambda wt: wt[0])
        median = total_power // 2
        for t_ns, power in weighted:
            if median <= power:
                return Timestamp(t_ns // 1_000_000_000,
                                 t_ns % 1_000_000_000)
            median -= power
        return Timestamp.zero()

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


@dataclass
class Header:
    version: Consensus = field(default_factory=Consensus)
    chain_id: str = ""
    height: int = 0
    time: Timestamp = field(default_factory=Timestamp.zero)
    last_block_id: BlockID = field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""

    def hash(self) -> bytes | None:
        """Merkle root of the 14 proto-encoded fields (block.go Hash);
        None without a validators hash."""
        if not self.validators_hash:
            return None
        return merkle.hash_from_byte_slices([
            self.version.to_proto(),
            _cdc_string(self.chain_id),
            _cdc_int64(self.height),
            self.time.to_proto(),
            self.last_block_id.to_proto(),
            _cdc_bytes(self.last_commit_hash),
            _cdc_bytes(self.data_hash),
            _cdc_bytes(self.validators_hash),
            _cdc_bytes(self.next_validators_hash),
            _cdc_bytes(self.consensus_hash),
            _cdc_bytes(self.app_hash),
            _cdc_bytes(self.last_results_hash),
            _cdc_bytes(self.evidence_hash),
            _cdc_bytes(self.proposer_address),
        ])

    def to_proto(self) -> bytes:
        return (pw.Writer()
                .message_field(1, self.version.to_proto())
                .string_field(2, self.chain_id)
                .int_field(3, self.height)
                .message_field(4, self.time.to_proto())
                .message_field(5, self.last_block_id.to_proto())
                .bytes_field(6, self.last_commit_hash)
                .bytes_field(7, self.data_hash)
                .bytes_field(8, self.validators_hash)
                .bytes_field(9, self.next_validators_hash)
                .bytes_field(10, self.consensus_hash)
                .bytes_field(11, self.app_hash)
                .bytes_field(12, self.last_results_hash)
                .bytes_field(13, self.evidence_hash)
                .bytes_field(14, self.proposer_address)
                .bytes())

    _HASH_FIELDS = ("last_commit_hash", "data_hash", "validators_hash",
                    "next_validators_hash", "consensus_hash", "app_hash",
                    "last_results_hash", "evidence_hash", "proposer_address")

    @staticmethod
    def from_proto(payload: bytes) -> "Header":
        r = pw.Reader(payload)
        h = Header()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                h.version = Consensus.from_proto(r.read_bytes())
            elif f == 2:
                h.chain_id = r.read_string()
            elif f == 3:
                h.height = r.read_int()
            elif f == 4:
                h.time = Timestamp.from_proto(r.read_bytes())
            elif f == 5:
                h.last_block_id = BlockID.from_proto(r.read_bytes())
            elif 6 <= f <= 14 and w == pw.BYTES:
                setattr(h, Header._HASH_FIELDS[f - 6], r.read_bytes())
            else:
                r.skip(w)
        return h

    def validate_basic(self) -> None:
        if len(self.chain_id) > 50:
            raise ValueError("chain_id too long")
        if self.height < 0:
            raise ValueError("negative Height")
        for name in ("last_commit_hash", "data_hash", "validators_hash",
                     "next_validators_hash", "consensus_hash",
                     "last_results_hash", "evidence_hash"):
            v = getattr(self, name)
            if v and len(v) != 32:
                raise ValueError(f"wrong {name} size")
        if self.proposer_address and len(self.proposer_address) != 20:
            raise ValueError("invalid proposer address size")


def tx_hash(tx: bytes) -> bytes:
    return sum_sha256(tx)


@dataclass
class Data:
    txs: list[bytes] = field(default_factory=list)
    _hash: bytes | None = None

    def hash(self) -> bytes:
        """Merkle root over the transactions' SHA-256 (their TxIDs)."""
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices(
                [tx_hash(tx) for tx in self.txs])
        return self._hash

    def to_proto(self) -> bytes:
        w = pw.Writer()
        for tx in self.txs:
            w.bytes_field(1, tx)
        return w.bytes()

    @staticmethod
    def from_proto(payload: bytes) -> "Data":
        r = pw.Reader(payload)
        txs = []
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                txs.append(r.read_bytes())
            else:
                r.skip(w)
        return Data(txs)


@dataclass
class Block:
    header: Header = field(default_factory=Header)
    data: Data = field(default_factory=Data)
    evidence: list = field(default_factory=list)
    last_commit: Commit | None = None

    def hash(self) -> bytes | None:
        return self.header.hash()

    def fill_header(self) -> None:
        """Fill the header's derived hashes (block.go fillHeader)."""
        if not self.header.last_commit_hash and self.last_commit:
            self.header.last_commit_hash = self.last_commit.hash()
        if not self.header.data_hash:
            self.header.data_hash = self.data.hash()
        if not self.header.evidence_hash:
            self.header.evidence_hash = evidence_hash(self.evidence)

    def to_proto(self) -> bytes:
        w = (pw.Writer()
             .message_field(1, self.header.to_proto())
             .message_field(2, self.data.to_proto())
             .message_field(3, evidence_list_proto(self.evidence)))
        if self.last_commit is not None:
            w.message_field(4, self.last_commit.to_proto())
        return w.bytes()

    @staticmethod
    def from_proto(payload: bytes) -> "Block":
        r = pw.Reader(payload)
        b = Block()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                b.header = Header.from_proto(r.read_bytes())
            elif f == 2:
                b.data = Data.from_proto(r.read_bytes())
            elif f == 3:
                b.evidence = evidence_list_from_proto(r.read_bytes())
            elif f == 4:
                b.last_commit = Commit.from_proto(r.read_bytes())
            else:
                r.skip(w)
        return b

    def validate_basic(self) -> None:
        """The last commit is required at every height (height 1 carries
        an empty one) and the header's derived hashes must match."""
        self.header.validate_basic()
        if self.last_commit is None:
            raise ValueError("nil LastCommit")
        self.last_commit.validate_basic()
        if self.header.last_commit_hash != self.last_commit.hash():
            raise ValueError("wrong LastCommitHash")
        if self.header.data_hash != self.data.hash():
            raise ValueError("wrong DataHash")
        if self.header.evidence_hash != evidence_hash(self.evidence):
            raise ValueError("wrong EvidenceHash")


def evidence_hash(evidence: list) -> bytes:
    """Merkle root over each item's proto bytes (EvidenceList.Hash)."""
    return merkle.hash_from_byte_slices([ev.bytes_() for ev in evidence])


def evidence_list_proto(evidence: list) -> bytes:
    from .evidence import evidence_to_proto_wrapped
    w = pw.Writer()
    for ev in evidence:
        w.message_field(1, evidence_to_proto_wrapped(ev))
    return w.bytes()


def evidence_list_from_proto(payload: bytes) -> list:
    from .evidence import evidence_from_proto_wrapped
    r = pw.Reader(payload)
    out = []
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1 and w == pw.BYTES:
            out.append(evidence_from_proto_wrapped(r.read_bytes()))
        else:
            r.skip(w)
    return out
