"""Byzantine evidence (the port's copy of `cometbft_tpu.types.evidence`;
CometBFT types/evidence.go).

DuplicateVoteEvidence: two conflicting votes of one validator at one
height, round and type; its hash is the SHA-256 of its proto bytes.
LightClientAttackEvidence: a conflicting light block, the common height
and the validators that provably signed it; its hash is the SHA-256 of
the conflicting header's hash (its last byte dropped, as CometBFT's
copy into tmhash.Size - 1 drops it) and the common height as a Go
varint.  Proto layouts: CometBFT proto/cometbft/types/v1/evidence.proto.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto.hash import sum_sha256
from ..libs import protowire as pw
from .timestamp import Timestamp
from .vote import Vote


def _put_varint_zigzag(v: int) -> bytes:
    """Go binary.PutVarint: zigzag, then uvarint."""
    zz = (v << 1) ^ (v >> 63) if v < 0 else v << 1
    return pw.encode_uvarint(zz)


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


@dataclass
class LightClientAttackEvidence:
    conflicting_block: object        # light.types.LightBlock
    common_height: int
    byzantine_validators: list = field(default_factory=list)
    total_voting_power: int = 0
    timestamp: Timestamp = field(default_factory=Timestamp.zero)

    TYPE = "light_client_attack"
    ABCI_TYPE = 2  # abci.MisbehaviorType LIGHT_CLIENT_ATTACK

    def height(self) -> int:
        return self.common_height

    def time(self) -> Timestamp:
        return self.timestamp

    def bytes_(self) -> bytes:
        return self.to_proto()

    def hash(self) -> bytes:
        """SHA-256 of the conflicting header hash's first 31 bytes, a
        zero byte, and the common height as a Go varint (evidence.go)."""
        h = self.conflicting_block.signed_header.header.hash()
        varint = _put_varint_zigzag(self.common_height)
        bz = bytearray(32 + len(varint))
        bz[:31] = h[:31]
        bz[32:] = varint
        return sum_sha256(bytes(bz))

    def to_proto(self) -> bytes:
        w = pw.Writer()
        if self.conflicting_block is not None:
            w.message_field(1, self.conflicting_block.to_proto())
        w.int_field(2, self.common_height)
        for v in self.byzantine_validators:
            w.message_field(3, v.to_proto())
        w.int_field(4, self.total_voting_power)
        w.message_field(5, self.timestamp.to_proto())
        return w.bytes()

    @staticmethod
    def from_proto(payload: bytes) -> "LightClientAttackEvidence":
        from ..light.types import LightBlock
        from .validator_set import Validator
        r = pw.Reader(payload)
        cb = None
        ch = tvp = 0
        byz = []
        ts = Timestamp.zero()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                cb = LightBlock.from_proto(r.read_bytes())
            elif f == 2:
                ch = r.read_int()
            elif f == 3:
                byz.append(Validator.from_proto(r.read_bytes()))
            elif f == 4:
                tvp = r.read_int()
            elif f == 5:
                ts = Timestamp.from_proto(r.read_bytes())
            else:
                r.skip(w)
        return LightClientAttackEvidence(cb, ch, byz, tvp, ts)


def get_byzantine_validators(common_valset, trusted_signed_header,
                             conflicting_block) -> list:
    """The validators that provably misbehaved (CometBFT
    LightClientAttackEvidence.GetByzantineValidators):
    - lunatic (a field derived by the state machine differs from the
      trusted header's): every common-set validator that signed the
      conflicting commit;
    - equivocation (same set, same round): the validators that signed
      both commits, for different blocks;
    - amnesia (same set, different rounds): none can be named."""
    from .block import BLOCK_ID_FLAG_COMMIT

    conf_header = conflicting_block.signed_header.header
    conf_commit = conflicting_block.signed_header.commit
    trusted_header = trusted_signed_header.header
    trusted_commit = trusted_signed_header.commit

    lunatic = any(
        getattr(conf_header, f) != getattr(trusted_header, f)
        for f in ("validators_hash", "next_validators_hash",
                  "consensus_hash", "app_hash", "last_results_hash"))

    byzantine = []
    if lunatic:
        for sig in conf_commit.signatures:
            if sig.block_id_flag != BLOCK_ID_FLAG_COMMIT:
                continue
            _, val = common_valset.get_by_address(sig.validator_address)
            if val is not None:
                byzantine.append(val)
        return byzantine
    if trusted_commit.round == conf_commit.round:
        trusted_signers = {
            s.validator_address for s in trusted_commit.signatures
            if s.block_id_flag == BLOCK_ID_FLAG_COMMIT}
        for sig in conf_commit.signatures:
            if sig.block_id_flag != BLOCK_ID_FLAG_COMMIT:
                continue
            if sig.validator_address in trusted_signers:
                _, val = conflicting_block.validator_set.get_by_address(
                    sig.validator_address)
                if val is not None:
                    byzantine.append(val)
        return byzantine
    return []


def evidence_to_proto_wrapped(ev) -> bytes:
    """Evidence oneof wrapper (evidence.proto): duplicate_vote_evidence =
    1, light_client_attack_evidence = 2."""
    if isinstance(ev, DuplicateVoteEvidence):
        return pw.Writer().message_field(1, ev.to_proto()).bytes()
    if isinstance(ev, LightClientAttackEvidence):
        return pw.Writer().message_field(2, ev.to_proto()).bytes()
    raise ValueError(f"unknown evidence type {type(ev)}")


def evidence_from_proto_wrapped(payload: bytes):
    r = pw.Reader(payload)
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1 and w == pw.BYTES:
            return DuplicateVoteEvidence.from_proto(r.read_bytes())
        if f == 2 and w == pw.BYTES:
            return LightClientAttackEvidence.from_proto(r.read_bytes())
        r.skip(w)
    raise ValueError("empty Evidence message")
