"""ABCI request/response types, wire-compatible with CometBFT's proto
(proto/cometbft/abci/v1/types.proto): the port's copy of the messages of
`cometbft_tpu.abci.types` that block execution, the state store and the
kvstore application use.

Every message is a plain dataclass with to_proto/from_proto.  Echo,
Flush and the Request/Response oneof wrappers of the socket protocol
are not ported: the port runs its application in process
(abci/client.LocalClient).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..libs import protowire as pw
from ..types.timestamp import Timestamp

# -- enums ------------------------------------------------------------------

CHECK_TX_TYPE_CHECK = 2
CHECK_TX_TYPE_RECHECK = 1

OFFER_SNAPSHOT_ACCEPT = 1
OFFER_SNAPSHOT_ABORT = 2
OFFER_SNAPSHOT_REJECT = 3
OFFER_SNAPSHOT_REJECT_FORMAT = 4
OFFER_SNAPSHOT_REJECT_SENDER = 5

APPLY_CHUNK_ACCEPT = 1
APPLY_CHUNK_ABORT = 2
APPLY_CHUNK_RETRY = 3
APPLY_CHUNK_RETRY_SNAPSHOT = 4
APPLY_CHUNK_REJECT_SNAPSHOT = 5

PROCESS_PROPOSAL_ACCEPT = 1
PROCESS_PROPOSAL_REJECT = 2

VERIFY_VOTE_EXT_ACCEPT = 1
VERIFY_VOTE_EXT_REJECT = 2

MISBEHAVIOR_DUPLICATE_VOTE = 1
MISBEHAVIOR_LIGHT_CLIENT_ATTACK = 2

CODE_TYPE_OK = 0


# -- supporting types -------------------------------------------------------

@dataclass
class EventAttribute:
    key: str = ""
    value: str = ""
    index: bool = False

    def to_proto(self) -> bytes:
        return (pw.Writer().string_field(1, self.key)
                .string_field(2, self.value)
                .bool_field(3, self.index).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "EventAttribute":
        r = pw.Reader(p)
        m = EventAttribute()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.key = r.read_string()
            elif f == 2 and w == pw.BYTES:
                m.value = r.read_string()
            elif f == 3 and w == pw.VARINT:
                m.index = bool(r.read_uvarint())
            else:
                r.skip(w)
        return m


@dataclass
class Event:
    type: str = ""
    attributes: list = field(default_factory=list)

    def to_proto(self) -> bytes:
        w = pw.Writer().string_field(1, self.type)
        for a in self.attributes:
            w.message_field(2, a.to_proto())
        return w.bytes()

    @staticmethod
    def from_proto(p: bytes) -> "Event":
        r = pw.Reader(p)
        m = Event()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.type = r.read_string()
            elif f == 2 and w == pw.BYTES:
                m.attributes.append(EventAttribute.from_proto(r.read_bytes()))
            else:
                r.skip(w)
        return m


@dataclass
class Validator:
    """abci.Validator: address + power (types.proto:520-527)."""
    address: bytes = b""
    power: int = 0

    def to_proto(self) -> bytes:
        return (pw.Writer().bytes_field(1, self.address)
                .int_field(3, self.power).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "Validator":
        r = pw.Reader(p)
        m = Validator()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.address = r.read_bytes()
            elif f == 3 and w == pw.VARINT:
                m.power = r.read_int()
            else:
                r.skip(w)
        return m


@dataclass
class ValidatorUpdate:
    """power + raw pubkey bytes + key type (types.proto:527-529)."""
    power: int = 0
    pub_key_bytes: bytes = b""
    pub_key_type: str = ""

    def to_proto(self) -> bytes:
        return (pw.Writer().int_field(2, self.power)
                .bytes_field(3, self.pub_key_bytes)
                .string_field(4, self.pub_key_type).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "ValidatorUpdate":
        r = pw.Reader(p)
        m = ValidatorUpdate()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 2 and w == pw.VARINT:
                m.power = r.read_int()
            elif f == 3 and w == pw.BYTES:
                m.pub_key_bytes = r.read_bytes()
            elif f == 4 and w == pw.BYTES:
                m.pub_key_type = r.read_string()
            else:
                r.skip(w)
        return m


@dataclass
class VoteInfo:
    validator: Validator = field(default_factory=Validator)
    block_id_flag: int = 0

    def to_proto(self) -> bytes:
        return (pw.Writer().message_field(1, self.validator.to_proto())
                .int_field(3, self.block_id_flag).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "VoteInfo":
        r = pw.Reader(p)
        m = VoteInfo()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.validator = Validator.from_proto(r.read_bytes())
            elif f == 3 and w == pw.VARINT:
                m.block_id_flag = r.read_int()
            else:
                r.skip(w)
        return m


@dataclass
class ExtendedVoteInfo:
    validator: Validator = field(default_factory=Validator)
    vote_extension: bytes = b""
    extension_signature: bytes = b""
    block_id_flag: int = 0

    def to_proto(self) -> bytes:
        return (pw.Writer().message_field(1, self.validator.to_proto())
                .bytes_field(3, self.vote_extension)
                .bytes_field(4, self.extension_signature)
                .int_field(5, self.block_id_flag).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "ExtendedVoteInfo":
        r = pw.Reader(p)
        m = ExtendedVoteInfo()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.validator = Validator.from_proto(r.read_bytes())
            elif f == 3 and w == pw.BYTES:
                m.vote_extension = r.read_bytes()
            elif f == 4 and w == pw.BYTES:
                m.extension_signature = r.read_bytes()
            elif f == 5 and w == pw.VARINT:
                m.block_id_flag = r.read_int()
            else:
                r.skip(w)
        return m


@dataclass
class CommitInfo:
    round: int = 0
    votes: list = field(default_factory=list)  # list[VoteInfo]

    def to_proto(self) -> bytes:
        w = pw.Writer().int_field(1, self.round)
        for v in self.votes:
            w.message_field(2, v.to_proto())
        return w.bytes()

    @staticmethod
    def from_proto(p: bytes) -> "CommitInfo":
        r = pw.Reader(p)
        m = CommitInfo()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.round = r.read_int()
            elif f == 2 and w == pw.BYTES:
                m.votes.append(VoteInfo.from_proto(r.read_bytes()))
            else:
                r.skip(w)
        return m


@dataclass
class ExtendedCommitInfo:
    round: int = 0
    votes: list = field(default_factory=list)  # list[ExtendedVoteInfo]

    def to_proto(self) -> bytes:
        w = pw.Writer().int_field(1, self.round)
        for v in self.votes:
            w.message_field(2, v.to_proto())
        return w.bytes()

    @staticmethod
    def from_proto(p: bytes) -> "ExtendedCommitInfo":
        r = pw.Reader(p)
        m = ExtendedCommitInfo()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.round = r.read_int()
            elif f == 2 and w == pw.BYTES:
                m.votes.append(ExtendedVoteInfo.from_proto(r.read_bytes()))
            else:
                r.skip(w)
        return m


@dataclass
class Misbehavior:
    type: int = 0
    validator: Validator = field(default_factory=Validator)
    height: int = 0
    time: Timestamp = field(default_factory=Timestamp.zero)
    total_voting_power: int = 0

    def to_proto(self) -> bytes:
        return (pw.Writer().int_field(1, self.type)
                .message_field(2, self.validator.to_proto())
                .int_field(3, self.height)
                .message_field(4, self.time.to_proto())
                .int_field(5, self.total_voting_power).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "Misbehavior":
        r = pw.Reader(p)
        m = Misbehavior()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.type = r.read_int()
            elif f == 2 and w == pw.BYTES:
                m.validator = Validator.from_proto(r.read_bytes())
            elif f == 3 and w == pw.VARINT:
                m.height = r.read_int()
            elif f == 4 and w == pw.BYTES:
                m.time = Timestamp.from_proto(r.read_bytes())
            elif f == 5 and w == pw.VARINT:
                m.total_voting_power = r.read_int()
            else:
                r.skip(w)
        return m


@dataclass
class Snapshot:
    height: int = 0
    format: int = 0
    chunks: int = 0
    hash: bytes = b""
    metadata: bytes = b""

    def to_proto(self) -> bytes:
        return (pw.Writer().uvarint_field(1, self.height)
                .uvarint_field(2, self.format)
                .uvarint_field(3, self.chunks)
                .bytes_field(4, self.hash)
                .bytes_field(5, self.metadata).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "Snapshot":
        r = pw.Reader(p)
        m = Snapshot()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.height = r.read_uvarint()
            elif f == 2 and w == pw.VARINT:
                m.format = r.read_uvarint()
            elif f == 3 and w == pw.VARINT:
                m.chunks = r.read_uvarint()
            elif f == 4 and w == pw.BYTES:
                m.hash = r.read_bytes()
            elif f == 5 and w == pw.BYTES:
                m.metadata = r.read_bytes()
            else:
                r.skip(w)
        return m


@dataclass
class ExecTxResult:
    code: int = 0
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list = field(default_factory=list)
    codespace: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK

    def to_proto(self) -> bytes:
        w = (pw.Writer().uvarint_field(1, self.code)
             .bytes_field(2, self.data).string_field(3, self.log)
             .string_field(4, self.info).int_field(5, self.gas_wanted)
             .int_field(6, self.gas_used))
        for e in self.events:
            w.message_field(7, e.to_proto())
        w.string_field(8, self.codespace)
        return w.bytes()

    @staticmethod
    def from_proto(p: bytes) -> "ExecTxResult":
        r = pw.Reader(p)
        m = ExecTxResult()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.code = r.read_uvarint()
            elif f == 2 and w == pw.BYTES:
                m.data = r.read_bytes()
            elif f == 3 and w == pw.BYTES:
                m.log = r.read_string()
            elif f == 4 and w == pw.BYTES:
                m.info = r.read_string()
            elif f == 5 and w == pw.VARINT:
                m.gas_wanted = r.read_int()
            elif f == 6 and w == pw.VARINT:
                m.gas_used = r.read_int()
            elif f == 7 and w == pw.BYTES:
                m.events.append(Event.from_proto(r.read_bytes()))
            elif f == 8 and w == pw.BYTES:
                m.codespace = r.read_string()
            else:
                r.skip(w)
        return m


# -- requests ---------------------------------------------------------------

@dataclass
class InfoRequest:
    version: str = ""
    block_version: int = 0
    p2p_version: int = 0
    abci_version: str = ""

    def to_proto(self) -> bytes:
        return (pw.Writer().string_field(1, self.version)
                .uvarint_field(2, self.block_version)
                .uvarint_field(3, self.p2p_version)
                .string_field(4, self.abci_version).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "InfoRequest":
        r = pw.Reader(p)
        m = InfoRequest()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.version = r.read_string()
            elif f == 2 and w == pw.VARINT:
                m.block_version = r.read_uvarint()
            elif f == 3 and w == pw.VARINT:
                m.p2p_version = r.read_uvarint()
            elif f == 4 and w == pw.BYTES:
                m.abci_version = r.read_string()
            else:
                r.skip(w)
        return m


@dataclass
class InitChainRequest:
    time: Timestamp = field(default_factory=Timestamp.zero)
    chain_id: str = ""
    consensus_params: bytes | None = None  # ConsensusParams proto
    validators: list = field(default_factory=list)  # list[ValidatorUpdate]
    app_state_bytes: bytes = b""
    initial_height: int = 0

    def to_proto(self) -> bytes:
        w = (pw.Writer().message_field(1, self.time.to_proto())
             .string_field(2, self.chain_id))
        if self.consensus_params is not None:
            w.message_field(3, self.consensus_params)
        for v in self.validators:
            w.message_field(4, v.to_proto())
        w.bytes_field(5, self.app_state_bytes)
        w.int_field(6, self.initial_height)
        return w.bytes()

    @staticmethod
    def from_proto(p: bytes) -> "InitChainRequest":
        r = pw.Reader(p)
        m = InitChainRequest()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.time = Timestamp.from_proto(r.read_bytes())
            elif f == 2 and w == pw.BYTES:
                m.chain_id = r.read_string()
            elif f == 3 and w == pw.BYTES:
                m.consensus_params = r.read_bytes()
            elif f == 4 and w == pw.BYTES:
                m.validators.append(ValidatorUpdate.from_proto(r.read_bytes()))
            elif f == 5 and w == pw.BYTES:
                m.app_state_bytes = r.read_bytes()
            elif f == 6 and w == pw.VARINT:
                m.initial_height = r.read_int()
            else:
                r.skip(w)
        return m


@dataclass
class QueryRequest:
    data: bytes = b""
    path: str = ""
    height: int = 0
    prove: bool = False

    def to_proto(self) -> bytes:
        return (pw.Writer().bytes_field(1, self.data)
                .string_field(2, self.path).int_field(3, self.height)
                .bool_field(4, self.prove).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "QueryRequest":
        r = pw.Reader(p)
        m = QueryRequest()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.data = r.read_bytes()
            elif f == 2 and w == pw.BYTES:
                m.path = r.read_string()
            elif f == 3 and w == pw.VARINT:
                m.height = r.read_int()
            elif f == 4 and w == pw.VARINT:
                m.prove = bool(r.read_uvarint())
            else:
                r.skip(w)
        return m


@dataclass
class CheckTxRequest:
    tx: bytes = b""
    type: int = CHECK_TX_TYPE_CHECK

    def to_proto(self) -> bytes:
        return (pw.Writer().bytes_field(1, self.tx)
                .int_field(3, self.type).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "CheckTxRequest":
        r = pw.Reader(p)
        m = CheckTxRequest(type=0)
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.tx = r.read_bytes()
            elif f == 3 and w == pw.VARINT:
                m.type = r.read_int()
            else:
                r.skip(w)
        return m


@dataclass
class CommitRequest:
    def to_proto(self) -> bytes:
        return b""

    @staticmethod
    def from_proto(p: bytes) -> "CommitRequest":
        return CommitRequest()


@dataclass
class ListSnapshotsRequest:
    def to_proto(self) -> bytes:
        return b""

    @staticmethod
    def from_proto(p: bytes) -> "ListSnapshotsRequest":
        return ListSnapshotsRequest()


@dataclass
class OfferSnapshotRequest:
    snapshot: Snapshot = field(default_factory=Snapshot)
    app_hash: bytes = b""

    def to_proto(self) -> bytes:
        return (pw.Writer().message_field(1, self.snapshot.to_proto())
                .bytes_field(2, self.app_hash).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "OfferSnapshotRequest":
        r = pw.Reader(p)
        m = OfferSnapshotRequest()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.snapshot = Snapshot.from_proto(r.read_bytes())
            elif f == 2 and w == pw.BYTES:
                m.app_hash = r.read_bytes()
            else:
                r.skip(w)
        return m


@dataclass
class LoadSnapshotChunkRequest:
    height: int = 0
    format: int = 0
    chunk: int = 0

    def to_proto(self) -> bytes:
        return (pw.Writer().uvarint_field(1, self.height)
                .uvarint_field(2, self.format)
                .uvarint_field(3, self.chunk).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "LoadSnapshotChunkRequest":
        r = pw.Reader(p)
        m = LoadSnapshotChunkRequest()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.height = r.read_uvarint()
            elif f == 2 and w == pw.VARINT:
                m.format = r.read_uvarint()
            elif f == 3 and w == pw.VARINT:
                m.chunk = r.read_uvarint()
            else:
                r.skip(w)
        return m


@dataclass
class ApplySnapshotChunkRequest:
    index: int = 0
    chunk: bytes = b""
    sender: str = ""

    def to_proto(self) -> bytes:
        return (pw.Writer().uvarint_field(1, self.index)
                .bytes_field(2, self.chunk)
                .string_field(3, self.sender).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "ApplySnapshotChunkRequest":
        r = pw.Reader(p)
        m = ApplySnapshotChunkRequest()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.index = r.read_uvarint()
            elif f == 2 and w == pw.BYTES:
                m.chunk = r.read_bytes()
            elif f == 3 and w == pw.BYTES:
                m.sender = r.read_string()
            else:
                r.skip(w)
        return m


@dataclass
class PrepareProposalRequest:
    max_tx_bytes: int = 0
    txs: list = field(default_factory=list)
    local_last_commit: ExtendedCommitInfo = field(
        default_factory=ExtendedCommitInfo)
    misbehavior: list = field(default_factory=list)
    height: int = 0
    time: Timestamp = field(default_factory=Timestamp.zero)
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""

    def to_proto(self) -> bytes:
        w = pw.Writer().int_field(1, self.max_tx_bytes)
        for tx in self.txs:
            w.bytes_field(2, tx)
        w.message_field(3, self.local_last_commit.to_proto())
        for mb in self.misbehavior:
            w.message_field(4, mb.to_proto())
        w.int_field(5, self.height)
        w.message_field(6, self.time.to_proto())
        w.bytes_field(7, self.next_validators_hash)
        w.bytes_field(8, self.proposer_address)
        return w.bytes()

    @staticmethod
    def from_proto(p: bytes) -> "PrepareProposalRequest":
        r = pw.Reader(p)
        m = PrepareProposalRequest()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.max_tx_bytes = r.read_int()
            elif f == 2 and w == pw.BYTES:
                m.txs.append(r.read_bytes())
            elif f == 3 and w == pw.BYTES:
                m.local_last_commit = ExtendedCommitInfo.from_proto(
                    r.read_bytes())
            elif f == 4 and w == pw.BYTES:
                m.misbehavior.append(Misbehavior.from_proto(r.read_bytes()))
            elif f == 5 and w == pw.VARINT:
                m.height = r.read_int()
            elif f == 6 and w == pw.BYTES:
                m.time = Timestamp.from_proto(r.read_bytes())
            elif f == 7 and w == pw.BYTES:
                m.next_validators_hash = r.read_bytes()
            elif f == 8 and w == pw.BYTES:
                m.proposer_address = r.read_bytes()
            else:
                r.skip(w)
        return m


@dataclass
class ProcessProposalRequest:
    txs: list = field(default_factory=list)
    proposed_last_commit: CommitInfo = field(default_factory=CommitInfo)
    misbehavior: list = field(default_factory=list)
    hash: bytes = b""
    height: int = 0
    time: Timestamp = field(default_factory=Timestamp.zero)
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""

    def to_proto(self) -> bytes:
        w = pw.Writer()
        for tx in self.txs:
            w.bytes_field(1, tx)
        w.message_field(2, self.proposed_last_commit.to_proto())
        for mb in self.misbehavior:
            w.message_field(3, mb.to_proto())
        w.bytes_field(4, self.hash)
        w.int_field(5, self.height)
        w.message_field(6, self.time.to_proto())
        w.bytes_field(7, self.next_validators_hash)
        w.bytes_field(8, self.proposer_address)
        return w.bytes()

    @staticmethod
    def from_proto(p: bytes) -> "ProcessProposalRequest":
        r = pw.Reader(p)
        m = ProcessProposalRequest()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.txs.append(r.read_bytes())
            elif f == 2 and w == pw.BYTES:
                m.proposed_last_commit = CommitInfo.from_proto(r.read_bytes())
            elif f == 3 and w == pw.BYTES:
                m.misbehavior.append(Misbehavior.from_proto(r.read_bytes()))
            elif f == 4 and w == pw.BYTES:
                m.hash = r.read_bytes()
            elif f == 5 and w == pw.VARINT:
                m.height = r.read_int()
            elif f == 6 and w == pw.BYTES:
                m.time = Timestamp.from_proto(r.read_bytes())
            elif f == 7 and w == pw.BYTES:
                m.next_validators_hash = r.read_bytes()
            elif f == 8 and w == pw.BYTES:
                m.proposer_address = r.read_bytes()
            else:
                r.skip(w)
        return m


@dataclass
class FinalizeBlockRequest:
    txs: list = field(default_factory=list)
    decided_last_commit: CommitInfo = field(default_factory=CommitInfo)
    misbehavior: list = field(default_factory=list)
    hash: bytes = b""
    height: int = 0
    time: Timestamp = field(default_factory=Timestamp.zero)
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""
    syncing_to_height: int = 0

    def to_proto(self) -> bytes:
        w = pw.Writer()
        for tx in self.txs:
            w.bytes_field(1, tx)
        w.message_field(2, self.decided_last_commit.to_proto())
        for mb in self.misbehavior:
            w.message_field(3, mb.to_proto())
        w.bytes_field(4, self.hash)
        w.int_field(5, self.height)
        w.message_field(6, self.time.to_proto())
        w.bytes_field(7, self.next_validators_hash)
        w.bytes_field(8, self.proposer_address)
        w.int_field(9, self.syncing_to_height)
        return w.bytes()

    @staticmethod
    def from_proto(p: bytes) -> "FinalizeBlockRequest":
        r = pw.Reader(p)
        m = FinalizeBlockRequest()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.txs.append(r.read_bytes())
            elif f == 2 and w == pw.BYTES:
                m.decided_last_commit = CommitInfo.from_proto(r.read_bytes())
            elif f == 3 and w == pw.BYTES:
                m.misbehavior.append(Misbehavior.from_proto(r.read_bytes()))
            elif f == 4 and w == pw.BYTES:
                m.hash = r.read_bytes()
            elif f == 5 and w == pw.VARINT:
                m.height = r.read_int()
            elif f == 6 and w == pw.BYTES:
                m.time = Timestamp.from_proto(r.read_bytes())
            elif f == 7 and w == pw.BYTES:
                m.next_validators_hash = r.read_bytes()
            elif f == 8 and w == pw.BYTES:
                m.proposer_address = r.read_bytes()
            elif f == 9 and w == pw.VARINT:
                m.syncing_to_height = r.read_int()
            else:
                r.skip(w)
        return m


# -- responses --------------------------------------------------------------

@dataclass
class InfoResponse:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""

    def to_proto(self) -> bytes:
        return (pw.Writer().string_field(1, self.data)
                .string_field(2, self.version)
                .uvarint_field(3, self.app_version)
                .int_field(4, self.last_block_height)
                .bytes_field(5, self.last_block_app_hash).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "InfoResponse":
        r = pw.Reader(p)
        m = InfoResponse()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.data = r.read_string()
            elif f == 2 and w == pw.BYTES:
                m.version = r.read_string()
            elif f == 3 and w == pw.VARINT:
                m.app_version = r.read_uvarint()
            elif f == 4 and w == pw.VARINT:
                m.last_block_height = r.read_int()
            elif f == 5 and w == pw.BYTES:
                m.last_block_app_hash = r.read_bytes()
            else:
                r.skip(w)
        return m


@dataclass
class InitChainResponse:
    consensus_params: bytes | None = None  # ConsensusParams proto
    validators: list = field(default_factory=list)  # list[ValidatorUpdate]
    app_hash: bytes = b""

    def to_proto(self) -> bytes:
        w = pw.Writer()
        if self.consensus_params is not None:
            w.message_field(1, self.consensus_params)
        for v in self.validators:
            w.message_field(2, v.to_proto())
        w.bytes_field(3, self.app_hash)
        return w.bytes()

    @staticmethod
    def from_proto(p: bytes) -> "InitChainResponse":
        r = pw.Reader(p)
        m = InitChainResponse()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.consensus_params = r.read_bytes()
            elif f == 2 and w == pw.BYTES:
                m.validators.append(ValidatorUpdate.from_proto(r.read_bytes()))
            elif f == 3 and w == pw.BYTES:
                m.app_hash = r.read_bytes()
            else:
                r.skip(w)
        return m


@dataclass
class QueryResponse:
    code: int = 0
    log: str = ""
    info: str = ""
    index: int = 0
    key: bytes = b""
    value: bytes = b""
    proof_ops: bytes | None = None
    height: int = 0
    codespace: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK

    def to_proto(self) -> bytes:
        w = (pw.Writer().uvarint_field(1, self.code)
             .string_field(3, self.log).string_field(4, self.info)
             .int_field(5, self.index).bytes_field(6, self.key)
             .bytes_field(7, self.value))
        if self.proof_ops is not None:
            w.message_field(8, self.proof_ops)
        w.int_field(9, self.height)
        w.string_field(10, self.codespace)
        return w.bytes()

    @staticmethod
    def from_proto(p: bytes) -> "QueryResponse":
        r = pw.Reader(p)
        m = QueryResponse()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.code = r.read_uvarint()
            elif f == 3 and w == pw.BYTES:
                m.log = r.read_string()
            elif f == 4 and w == pw.BYTES:
                m.info = r.read_string()
            elif f == 5 and w == pw.VARINT:
                m.index = r.read_int()
            elif f == 6 and w == pw.BYTES:
                m.key = r.read_bytes()
            elif f == 7 and w == pw.BYTES:
                m.value = r.read_bytes()
            elif f == 8 and w == pw.BYTES:
                m.proof_ops = r.read_bytes()
            elif f == 9 and w == pw.VARINT:
                m.height = r.read_int()
            elif f == 10 and w == pw.BYTES:
                m.codespace = r.read_string()
            else:
                r.skip(w)
        return m


@dataclass
class CheckTxResponse:
    code: int = 0
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list = field(default_factory=list)
    codespace: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK

    def to_proto(self) -> bytes:
        w = (pw.Writer().uvarint_field(1, self.code)
             .bytes_field(2, self.data).string_field(3, self.log)
             .string_field(4, self.info).int_field(5, self.gas_wanted)
             .int_field(6, self.gas_used))
        for e in self.events:
            w.message_field(7, e.to_proto())
        w.string_field(8, self.codespace)
        return w.bytes()

    @staticmethod
    def from_proto(p: bytes) -> "CheckTxResponse":
        r = pw.Reader(p)
        m = CheckTxResponse()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.code = r.read_uvarint()
            elif f == 2 and w == pw.BYTES:
                m.data = r.read_bytes()
            elif f == 3 and w == pw.BYTES:
                m.log = r.read_string()
            elif f == 4 and w == pw.BYTES:
                m.info = r.read_string()
            elif f == 5 and w == pw.VARINT:
                m.gas_wanted = r.read_int()
            elif f == 6 and w == pw.VARINT:
                m.gas_used = r.read_int()
            elif f == 7 and w == pw.BYTES:
                m.events.append(Event.from_proto(r.read_bytes()))
            elif f == 8 and w == pw.BYTES:
                m.codespace = r.read_string()
            else:
                r.skip(w)
        return m


@dataclass
class CommitResponse:
    retain_height: int = 0

    def to_proto(self) -> bytes:
        return pw.Writer().int_field(3, self.retain_height).bytes()

    @staticmethod
    def from_proto(p: bytes) -> "CommitResponse":
        r = pw.Reader(p)
        m = CommitResponse()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 3 and w == pw.VARINT:
                m.retain_height = r.read_int()
            else:
                r.skip(w)
        return m


@dataclass
class ListSnapshotsResponse:
    snapshots: list = field(default_factory=list)

    def to_proto(self) -> bytes:
        w = pw.Writer()
        for s in self.snapshots:
            w.message_field(1, s.to_proto())
        return w.bytes()

    @staticmethod
    def from_proto(p: bytes) -> "ListSnapshotsResponse":
        r = pw.Reader(p)
        m = ListSnapshotsResponse()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.snapshots.append(Snapshot.from_proto(r.read_bytes()))
            else:
                r.skip(w)
        return m


@dataclass
class OfferSnapshotResponse:
    result: int = 0

    def to_proto(self) -> bytes:
        return pw.Writer().int_field(1, self.result).bytes()

    @staticmethod
    def from_proto(p: bytes) -> "OfferSnapshotResponse":
        r = pw.Reader(p)
        m = OfferSnapshotResponse()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.result = r.read_int()
            else:
                r.skip(w)
        return m


@dataclass
class LoadSnapshotChunkResponse:
    chunk: bytes = b""

    def to_proto(self) -> bytes:
        return pw.Writer().bytes_field(1, self.chunk).bytes()

    @staticmethod
    def from_proto(p: bytes) -> "LoadSnapshotChunkResponse":
        r = pw.Reader(p)
        m = LoadSnapshotChunkResponse()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.chunk = r.read_bytes()
            else:
                r.skip(w)
        return m


@dataclass
class ApplySnapshotChunkResponse:
    result: int = 0
    refetch_chunks: list = field(default_factory=list)
    reject_senders: list = field(default_factory=list)

    def to_proto(self) -> bytes:
        w = pw.Writer().int_field(1, self.result)
        for c in self.refetch_chunks:
            w.uvarint_field(2, c)
        for s in self.reject_senders:
            w.string_field(3, s)
        return w.bytes()

    @staticmethod
    def from_proto(p: bytes) -> "ApplySnapshotChunkResponse":
        r = pw.Reader(p)
        m = ApplySnapshotChunkResponse()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.result = r.read_int()
            elif f == 2 and w == pw.VARINT:
                m.refetch_chunks.append(r.read_uvarint())
            elif f == 3 and w == pw.BYTES:
                m.reject_senders.append(r.read_string())
            else:
                r.skip(w)
        return m


@dataclass
class PrepareProposalResponse:
    txs: list = field(default_factory=list)

    def to_proto(self) -> bytes:
        w = pw.Writer()
        for tx in self.txs:
            w.bytes_field(1, tx)
        return w.bytes()

    @staticmethod
    def from_proto(p: bytes) -> "PrepareProposalResponse":
        r = pw.Reader(p)
        m = PrepareProposalResponse()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.txs.append(r.read_bytes())
            else:
                r.skip(w)
        return m


@dataclass
class ProcessProposalResponse:
    status: int = 0

    @property
    def is_accepted(self) -> bool:
        return self.status == PROCESS_PROPOSAL_ACCEPT

    def to_proto(self) -> bytes:
        return pw.Writer().int_field(1, self.status).bytes()

    @staticmethod
    def from_proto(p: bytes) -> "ProcessProposalResponse":
        r = pw.Reader(p)
        m = ProcessProposalResponse()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.status = r.read_int()
            else:
                r.skip(w)
        return m


@dataclass
class FinalizeBlockResponse:
    events: list = field(default_factory=list)
    tx_results: list = field(default_factory=list)  # list[ExecTxResult]
    validator_updates: list = field(default_factory=list)
    consensus_param_updates: bytes | None = None  # ConsensusParams proto
    app_hash: bytes = b""

    def to_proto(self) -> bytes:
        w = pw.Writer()
        for e in self.events:
            w.message_field(1, e.to_proto())
        for t in self.tx_results:
            w.message_field(2, t.to_proto())
        for v in self.validator_updates:
            w.message_field(3, v.to_proto())
        if self.consensus_param_updates is not None:
            w.message_field(4, self.consensus_param_updates)
        w.bytes_field(5, self.app_hash)
        return w.bytes()

    @staticmethod
    def from_proto(p: bytes) -> "FinalizeBlockResponse":
        r = pw.Reader(p)
        m = FinalizeBlockResponse()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.events.append(Event.from_proto(r.read_bytes()))
            elif f == 2 and w == pw.BYTES:
                m.tx_results.append(ExecTxResult.from_proto(r.read_bytes()))
            elif f == 3 and w == pw.BYTES:
                m.validator_updates.append(
                    ValidatorUpdate.from_proto(r.read_bytes()))
            elif f == 4 and w == pw.BYTES:
                m.consensus_param_updates = r.read_bytes()
            elif f == 5 and w == pw.BYTES:
                m.app_hash = r.read_bytes()
            else:
                r.skip(w)
        return m


@dataclass
class ExtendVoteRequest:
    hash: bytes = b""
    height: int = 0
    time: Timestamp = field(default_factory=Timestamp.zero)
    txs: list = field(default_factory=list)
    proposed_last_commit: CommitInfo = field(default_factory=CommitInfo)
    misbehavior: list = field(default_factory=list)
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""

    def to_proto(self) -> bytes:
        w = (pw.Writer().bytes_field(1, self.hash).int_field(2, self.height)
             .message_field(3, self.time.to_proto()))
        for tx in self.txs:
            w.bytes_field(4, tx)
        w.message_field(5, self.proposed_last_commit.to_proto())
        for mb in self.misbehavior:
            w.message_field(6, mb.to_proto())
        w.bytes_field(7, self.next_validators_hash)
        w.bytes_field(8, self.proposer_address)
        return w.bytes()

    @staticmethod
    def from_proto(p: bytes) -> "ExtendVoteRequest":
        r = pw.Reader(p)
        m = ExtendVoteRequest()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.hash = r.read_bytes()
            elif f == 2 and w == pw.VARINT:
                m.height = r.read_int()
            elif f == 3 and w == pw.BYTES:
                m.time = Timestamp.from_proto(r.read_bytes())
            elif f == 4 and w == pw.BYTES:
                m.txs.append(r.read_bytes())
            elif f == 5 and w == pw.BYTES:
                m.proposed_last_commit = CommitInfo.from_proto(r.read_bytes())
            elif f == 6 and w == pw.BYTES:
                m.misbehavior.append(Misbehavior.from_proto(r.read_bytes()))
            elif f == 7 and w == pw.BYTES:
                m.next_validators_hash = r.read_bytes()
            elif f == 8 and w == pw.BYTES:
                m.proposer_address = r.read_bytes()
            else:
                r.skip(w)
        return m


@dataclass
class VerifyVoteExtensionRequest:
    hash: bytes = b""
    validator_address: bytes = b""
    height: int = 0
    vote_extension: bytes = b""

    def to_proto(self) -> bytes:
        return (pw.Writer().bytes_field(1, self.hash)
                .bytes_field(2, self.validator_address)
                .int_field(3, self.height)
                .bytes_field(4, self.vote_extension).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "VerifyVoteExtensionRequest":
        r = pw.Reader(p)
        m = VerifyVoteExtensionRequest()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.hash = r.read_bytes()
            elif f == 2 and w == pw.BYTES:
                m.validator_address = r.read_bytes()
            elif f == 3 and w == pw.VARINT:
                m.height = r.read_int()
            elif f == 4 and w == pw.BYTES:
                m.vote_extension = r.read_bytes()
            else:
                r.skip(w)
        return m


@dataclass
class ExtendVoteResponse:
    vote_extension: bytes = b""

    def to_proto(self) -> bytes:
        return pw.Writer().bytes_field(1, self.vote_extension).bytes()

    @staticmethod
    def from_proto(p: bytes) -> "ExtendVoteResponse":
        r = pw.Reader(p)
        m = ExtendVoteResponse()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.vote_extension = r.read_bytes()
            else:
                r.skip(w)
        return m


@dataclass
class VerifyVoteExtensionResponse:
    status: int = 0

    @property
    def is_accepted(self) -> bool:
        return self.status == VERIFY_VOTE_EXT_ACCEPT

    def to_proto(self) -> bytes:
        return pw.Writer().int_field(1, self.status).bytes()

    @staticmethod
    def from_proto(p: bytes) -> "VerifyVoteExtensionResponse":
        r = pw.Reader(p)
        m = VerifyVoteExtensionResponse()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.status = r.read_int()
            else:
                r.skip(w)
        return m
