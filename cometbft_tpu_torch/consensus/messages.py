"""Consensus wire messages (the port's copy of
`cometbft_tpu.consensus.messages`; CometBFT
proto/cometbft/consensus/v1/types.proto, internal/consensus/msgs.go).

These are both the p2p gossip payloads (channels 0x20-0x23) and the
units written to the consensus WAL (wrapped in wal.MsgInfo).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..libs import protowire as pw
from ..libs.bits import BitArray
from ..types.block import BlockID, PartSetHeader
from ..types.part_set import Part
from ..types.vote import Proposal, Vote


@dataclass
class NewRoundStepMessage:
    """Sent for every height/round/step transition."""
    height: int = 0
    round: int = 0
    step: int = 0
    seconds_since_start_time: int = 0
    last_commit_round: int = 0

    FIELD = 1

    def validate_basic(self) -> None:
        if self.height < 0 or self.round < 0:
            raise ValueError("negative height/round")
        if not 1 <= self.step <= 8:
            raise ValueError("invalid step")
        if self.height == 1 and self.last_commit_round != -1:
            raise ValueError("last_commit_round must be -1 for initial height")

    def to_proto(self) -> bytes:
        w = (pw.Writer().int_field(1, self.height)
             .int_field(2, self.round)
             .uvarint_field(3, self.step)
             .int_field(4, self.seconds_since_start_time))
        # int32 last_commit_round: varint two's complement (may be -1)
        w.int_field(5, self.last_commit_round)
        return w.bytes()

    @staticmethod
    def from_proto(p: bytes) -> "NewRoundStepMessage":
        r = pw.Reader(p)
        m = NewRoundStepMessage()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.height = r.read_int()
            elif f == 2 and w == pw.VARINT:
                m.round = r.read_int()
            elif f == 3 and w == pw.VARINT:
                m.step = r.read_uvarint()
            elif f == 4 and w == pw.VARINT:
                m.seconds_since_start_time = r.read_int()
            elif f == 5 and w == pw.VARINT:
                m.last_commit_round = r.read_int()
            else:
                r.skip(w)
        return m


@dataclass
class NewValidBlockMessage:
    """A block got a POL (or was committed) in the given round."""
    height: int = 0
    round: int = 0
    block_part_set_header: PartSetHeader = field(
        default_factory=PartSetHeader)
    block_parts: BitArray | None = None
    is_commit: bool = False

    FIELD = 2

    def to_proto(self) -> bytes:
        w = (pw.Writer().int_field(1, self.height)
             .int_field(2, self.round)
             .message_field(3, self.block_part_set_header.to_proto()))
        if self.block_parts is not None:
            w.message_field(4, self.block_parts.to_proto())
        w.bool_field(5, self.is_commit)
        return w.bytes()

    @staticmethod
    def from_proto(p: bytes) -> "NewValidBlockMessage":
        r = pw.Reader(p)
        m = NewValidBlockMessage()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.height = r.read_int()
            elif f == 2 and w == pw.VARINT:
                m.round = r.read_int()
            elif f == 3 and w == pw.BYTES:
                m.block_part_set_header = PartSetHeader.from_proto(
                    r.read_bytes())
            elif f == 4 and w == pw.BYTES:
                m.block_parts = BitArray.from_proto(r.read_bytes())
            elif f == 5 and w == pw.VARINT:
                m.is_commit = bool(r.read_uvarint())
            else:
                r.skip(w)
        return m


@dataclass
class ProposalMessage:
    proposal: Proposal = None

    FIELD = 3

    def to_proto(self) -> bytes:
        return pw.Writer().message_field(
            1, self.proposal.to_proto()).bytes()

    @staticmethod
    def from_proto(p: bytes) -> "ProposalMessage":
        r = pw.Reader(p)
        m = ProposalMessage(Proposal())
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.proposal = Proposal.from_proto(r.read_bytes())
            else:
                r.skip(w)
        return m


@dataclass
class ProposalPOLMessage:
    height: int = 0
    proposal_pol_round: int = 0
    proposal_pol: BitArray | None = None

    FIELD = 4

    def to_proto(self) -> bytes:
        return (pw.Writer().int_field(1, self.height)
                .int_field(2, self.proposal_pol_round)
                .message_field(3, (self.proposal_pol
                                   or BitArray(0)).to_proto()).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "ProposalPOLMessage":
        r = pw.Reader(p)
        m = ProposalPOLMessage()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.height = r.read_int()
            elif f == 2 and w == pw.VARINT:
                m.proposal_pol_round = r.read_int()
            elif f == 3 and w == pw.BYTES:
                m.proposal_pol = BitArray.from_proto(r.read_bytes())
            else:
                r.skip(w)
        return m


@dataclass
class BlockPartMessage:
    height: int = 0
    round: int = 0
    part: Part = None

    FIELD = 5

    def to_proto(self) -> bytes:
        return (pw.Writer().int_field(1, self.height)
                .int_field(2, self.round)
                .message_field(3, self.part.to_proto()).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "BlockPartMessage":
        r = pw.Reader(p)
        m = BlockPartMessage()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.height = r.read_int()
            elif f == 2 and w == pw.VARINT:
                m.round = r.read_int()
            elif f == 3 and w == pw.BYTES:
                m.part = Part.from_proto(r.read_bytes())
            else:
                r.skip(w)
        return m


@dataclass
class VoteMessage:
    vote: Vote = None

    FIELD = 6

    def to_proto(self) -> bytes:
        return pw.Writer().message_field(1, self.vote.to_proto()).bytes()

    @staticmethod
    def from_proto(p: bytes) -> "VoteMessage":
        r = pw.Reader(p)
        m = VoteMessage()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.vote = Vote.from_proto(r.read_bytes())
            else:
                r.skip(w)
        return m


@dataclass
class HasVoteMessage:
    height: int = 0
    round: int = 0
    type: int = 0
    index: int = 0

    FIELD = 7

    def to_proto(self) -> bytes:
        return (pw.Writer().int_field(1, self.height)
                .int_field(2, self.round).int_field(3, self.type)
                .int_field(4, self.index).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "HasVoteMessage":
        r = pw.Reader(p)
        m = HasVoteMessage()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.height = r.read_int()
            elif f == 2 and w == pw.VARINT:
                m.round = r.read_int()
            elif f == 3 and w == pw.VARINT:
                m.type = r.read_int()
            elif f == 4 and w == pw.VARINT:
                m.index = r.read_int()
            else:
                r.skip(w)
        return m


@dataclass
class VoteSetMaj23Message:
    height: int = 0
    round: int = 0
    type: int = 0
    block_id: BlockID = field(default_factory=BlockID)

    FIELD = 8

    def to_proto(self) -> bytes:
        return (pw.Writer().int_field(1, self.height)
                .int_field(2, self.round).int_field(3, self.type)
                .message_field(4, self.block_id.to_proto()).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "VoteSetMaj23Message":
        r = pw.Reader(p)
        m = VoteSetMaj23Message()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.height = r.read_int()
            elif f == 2 and w == pw.VARINT:
                m.round = r.read_int()
            elif f == 3 and w == pw.VARINT:
                m.type = r.read_int()
            elif f == 4 and w == pw.BYTES:
                m.block_id = BlockID.from_proto(r.read_bytes())
            else:
                r.skip(w)
        return m


@dataclass
class VoteSetBitsMessage:
    height: int = 0
    round: int = 0
    type: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    votes: BitArray | None = None

    FIELD = 9

    def to_proto(self) -> bytes:
        return (pw.Writer().int_field(1, self.height)
                .int_field(2, self.round).int_field(3, self.type)
                .message_field(4, self.block_id.to_proto())
                .message_field(5, (self.votes
                                   or BitArray(0)).to_proto()).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "VoteSetBitsMessage":
        r = pw.Reader(p)
        m = VoteSetBitsMessage()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.height = r.read_int()
            elif f == 2 and w == pw.VARINT:
                m.round = r.read_int()
            elif f == 3 and w == pw.VARINT:
                m.type = r.read_int()
            elif f == 4 and w == pw.BYTES:
                m.block_id = BlockID.from_proto(r.read_bytes())
            elif f == 5 and w == pw.BYTES:
                m.votes = BitArray.from_proto(r.read_bytes())
            else:
                r.skip(w)
        return m


@dataclass
class HasProposalBlockPartMessage:
    height: int = 0
    round: int = 0
    index: int = 0

    FIELD = 10

    def to_proto(self) -> bytes:
        return (pw.Writer().int_field(1, self.height)
                .int_field(2, self.round).int_field(3, self.index).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "HasProposalBlockPartMessage":
        r = pw.Reader(p)
        m = HasProposalBlockPartMessage()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.height = r.read_int()
            elif f == 2 and w == pw.VARINT:
                m.round = r.read_int()
            elif f == 3 and w == pw.VARINT:
                m.index = r.read_int()
            else:
                r.skip(w)
        return m


_MESSAGE_TYPES = (
    NewRoundStepMessage, NewValidBlockMessage, ProposalMessage,
    ProposalPOLMessage, BlockPartMessage, VoteMessage, HasVoteMessage,
    VoteSetMaj23Message, VoteSetBitsMessage, HasProposalBlockPartMessage,
)
_BY_FIELD = {cls.FIELD: cls for cls in _MESSAGE_TYPES}


def wrap_message(msg) -> bytes:
    """Encode into the Message oneof envelope."""
    return pw.Writer().message_field(msg.FIELD, msg.to_proto()).bytes()


def unwrap_message(payload: bytes):
    """Decode a Message envelope into the concrete dataclass."""
    r = pw.Reader(payload)
    while not r.at_end():
        f, w = r.read_tag()
        if w == pw.BYTES and f in _BY_FIELD:
            return _BY_FIELD[f].from_proto(r.read_bytes())
        r.skip(w)
    raise ValueError("empty consensus Message")
