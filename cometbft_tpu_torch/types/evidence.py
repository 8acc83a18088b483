"""Duplicate-vote evidence (the port's copy of the DuplicateVoteEvidence
half of `cometbft_tpu.types.evidence`; CometBFT types/evidence.go).

Two conflicting votes of one validator at one height, round and type.
Proto layout: CometBFT proto/cometbft/types/v1/evidence.proto; the hash
is the SHA-256 of the proto bytes (evidence.go:107).
LightClientAttackEvidence needs the light-client types, which the port
does not have yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto.hash import sum_sha256
from ..libs import protowire as pw
from .timestamp import Timestamp
from .vote import Vote


@dataclass
class DuplicateVoteEvidence:
    vote_a: Vote
    vote_b: Vote
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp: Timestamp = field(default_factory=Timestamp.zero)

    TYPE = "duplicate_vote"
    ABCI_TYPE = 1  # abci.MisbehaviorType DUPLICATE_VOTE

    @staticmethod
    def new(vote_a: Vote, vote_b: Vote, block_time: Timestamp, valset):
        """Sorts votes by BlockID key (evidence.go NewDuplicateVoteEvidence)."""
        if vote_a is None or vote_b is None or valset is None:
            raise ValueError("missing vote or validator set")
        _, val = valset.get_by_address(vote_a.validator_address)
        if val is None:
            raise ValueError("validator not in set")
        if vote_a.block_id.key() < vote_b.block_id.key():
            first, second = vote_a, vote_b
        else:
            first, second = vote_b, vote_a
        return DuplicateVoteEvidence(
            vote_a=first, vote_b=second,
            total_voting_power=valset.total_voting_power(),
            validator_power=val.voting_power,
            timestamp=block_time)

    def height(self) -> int:
        return self.vote_a.height

    def time(self) -> Timestamp:
        return self.timestamp

    def bytes_(self) -> bytes:
        return self.to_proto()

    def hash(self) -> bytes:
        return sum_sha256(self.bytes_())

    def validate_basic(self) -> None:
        if self.vote_a is None or self.vote_b is None:
            raise ValueError("missing vote")
        self.vote_a.validate_basic()
        self.vote_b.validate_basic()
        if self.vote_a.block_id.key() >= self.vote_b.block_id.key():
            raise ValueError("duplicate votes in invalid order")

    def verify(self, chain_id: str, pubkey) -> None:
        """Same validator, H/R/S equal, different blocks, valid sigs
        (internal/evidence/verify.go VerifyDuplicateVote)."""
        a, b = self.vote_a, self.vote_b
        if a.height != b.height or a.round != b.round or a.type != b.type:
            raise ValueError("votes from different H/R/S")
        if a.block_id == b.block_id:
            raise ValueError("votes for the same block")
        if a.validator_address != b.validator_address:
            raise ValueError("votes from different validators")
        if pubkey.address() != a.validator_address:
            raise ValueError("address does not match pubkey")
        a.verify(chain_id, pubkey)
        b.verify(chain_id, pubkey)

    def to_proto(self) -> bytes:
        return (pw.Writer()
                .optional_message_field(1, self.vote_a.to_proto())
                .optional_message_field(2, self.vote_b.to_proto())
                .int_field(3, self.total_voting_power)
                .int_field(4, self.validator_power)
                .message_field(5, self.timestamp.to_proto())
                .bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "DuplicateVoteEvidence":
        r = pw.Reader(payload)
        va = vb = None
        tvp = vp = 0
        ts = Timestamp.zero()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                va = Vote.from_proto(r.read_bytes())
            elif f == 2:
                vb = Vote.from_proto(r.read_bytes())
            elif f == 3:
                tvp = r.read_int()
            elif f == 4:
                vp = r.read_int()
            elif f == 5:
                ts = Timestamp.from_proto(r.read_bytes())
            else:
                r.skip(w)
        return DuplicateVoteEvidence(va, vb, tvp, vp, ts)


def evidence_to_proto_wrapped(ev) -> bytes:
    """Evidence oneof wrapper (evidence.proto:14-19); the port knows the
    duplicate-vote member only."""
    if isinstance(ev, DuplicateVoteEvidence):
        return pw.Writer().message_field(1, ev.to_proto()).bytes()
    raise ValueError(f"unknown evidence type {type(ev)}")


def evidence_from_proto_wrapped(payload: bytes):
    r = pw.Reader(payload)
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1 and w == pw.BYTES:
            return DuplicateVoteEvidence.from_proto(r.read_bytes())
        if f == 2 and w == pw.BYTES:
            raise ValueError("light-client attack evidence is not ported")
        r.skip(w)
    raise ValueError("empty Evidence message")
