"""Vote and Proposal (the port's copy of `cometbft_tpu.types.vote`;
CometBFT types/vote.go, types/proposal.go).

A vote's signature verifies through crypto/batch.safe_verify, so the
verdict cache sits in front of it; the consensus reactor's streaming
pre-verification (crypto/votestream.Preverified) rides on the transient
`preverified` slot, which is not a wire field."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..libs import protowire as pw
from . import canonical
from .block import BlockID
from .timestamp import Timestamp

PREVOTE_TYPE = canonical.PREVOTE
PRECOMMIT_TYPE = canonical.PRECOMMIT
PROPOSAL_TYPE = canonical.PROPOSAL

MAX_VOTE_EXTENSION_SIZE = 1024 * 1024  # types/vote.go MaxVoteExtensionSize


def is_vote_type_valid(t: int) -> bool:
    return t in (PREVOTE_TYPE, PRECOMMIT_TYPE)


@dataclass
class Vote:
    type: int = PREVOTE_TYPE
    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    timestamp: Timestamp = field(default_factory=Timestamp.zero)
    validator_address: bytes = b""
    validator_index: int = -1
    signature: bytes = b""
    extension: bytes = b""
    extension_signature: bytes = b""

    # transient verdict attached by the consensus reactor's streaming
    # pre-verification (crypto/votestream.Preverified); not a wire field
    preverified = None

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.vote_sign_bytes(
            chain_id, self.type, self.height, self.round, self.block_id,
            self.timestamp)

    def extension_sign_bytes(self, chain_id: str) -> bytes:
        return canonical.vote_extension_sign_bytes(
            chain_id, self.height, self.round, self.extension)

    def verify(self, chain_id: str, pubkey) -> None:
        """vote.go:219-235: address match + signature check.

        The signature routes through the cached safe_verify seam
        (crypto/batch.py -> crypto/sigcache.py): an inline re-verify
        after a cancel-raced preverification both HITS a verdict the
        worker already resolved and INSERTS its own, so the same
        triple never verifies twice — at height H+1 this vote's
        LastCommit slot is a cache hit."""
        if pubkey.address() != self.validator_address:
            raise ValueError("invalid validator address")
        from ..crypto import batch as crypto_batch

        if not crypto_batch.safe_verify(pubkey,
                                        self.sign_bytes(chain_id),
                                        self.signature):
            raise ValueError("invalid signature")

    def verify_vote_and_extension(self, chain_id: str, pubkey) -> None:
        """vote.go:244-260: also checks the extension signature on
        non-nil precommits."""
        self.verify(chain_id, pubkey)
        self.verify_extension_signature(chain_id, pubkey)

    def verify_extension_signature(self, chain_id: str, pubkey) -> None:
        """Just the extension half (used when the main signature verdict
        came from the streaming pre-verifier)."""
        if self.type == PRECOMMIT_TYPE and not self.block_id.is_nil():
            if not pubkey.verify_signature(
                    self.extension_sign_bytes(chain_id),
                    self.extension_signature):
                raise ValueError("invalid extension signature")

    def is_nil(self) -> bool:
        return self.block_id.is_nil()

    def validate_basic(self) -> None:
        if not is_vote_type_valid(self.type):
            raise ValueError("invalid vote type")
        if self.height <= 0:
            raise ValueError("non-positive Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if not self.block_id.is_nil() and not self.block_id.is_complete():
            raise ValueError("blockID must be either empty or complete")
        if len(self.validator_address) != 20:
            raise ValueError("expected 20-byte validator address")
        if self.validator_index < 0:
            raise ValueError("negative ValidatorIndex")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > 64:
            raise ValueError("signature too big")
        # extension rules (vote.go:328-356): only non-nil precommits may
        # carry extensions; an extension requires its signature
        if self.type != PRECOMMIT_TYPE or self.block_id.is_nil():
            if self.extension or self.extension_signature:
                raise ValueError("unexpected vote extension")
        else:
            if len(self.extension_signature) > 64:
                raise ValueError("extension signature too big")
            if self.extension and not self.extension_signature:
                raise ValueError(
                    "vote extension present without extension signature")

    def to_proto(self) -> bytes:
        return (pw.Writer()
                .int_field(1, self.type)
                .int_field(2, self.height)
                .int_field(3, self.round)
                .message_field(4, self.block_id.to_proto())
                .message_field(5, self.timestamp.to_proto())
                .bytes_field(6, self.validator_address)
                .int_field(7, self.validator_index)
                .bytes_field(8, self.signature)
                .bytes_field(9, self.extension)
                .bytes_field(10, self.extension_signature)
                .bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "Vote":
        r = pw.Reader(payload)
        # proto3: omitted scalars are zero (not the dataclass default -1)
        v = Vote(validator_index=0)
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                v.type = r.read_int()
            elif f == 2:
                v.height = r.read_int()
            elif f == 3:
                v.round = r.read_int()
            elif f == 4:
                v.block_id = BlockID.from_proto(r.read_bytes())
            elif f == 5:
                v.timestamp = Timestamp.from_proto(r.read_bytes())
            elif f == 6:
                v.validator_address = r.read_bytes()
            elif f == 7:
                v.validator_index = r.read_int()
            elif f == 8:
                v.signature = r.read_bytes()
            elif f == 9:
                v.extension = r.read_bytes()
            elif f == 10:
                v.extension_signature = r.read_bytes()
            else:
                r.skip(w)
        return v


@dataclass
class Proposal:
    type: int = PROPOSAL_TYPE
    height: int = 0
    round: int = 0
    pol_round: int = -1
    block_id: BlockID = field(default_factory=BlockID)
    timestamp: Timestamp = field(default_factory=Timestamp.zero)
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.proposal_sign_bytes(
            chain_id, self.height, self.round, self.pol_round,
            self.block_id, self.timestamp)

    def validate_basic(self) -> None:
        if self.type != PROPOSAL_TYPE:
            raise ValueError("invalid proposal type")
        if self.height <= 0:
            raise ValueError("non-positive Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.pol_round < -1 or self.pol_round >= self.round:
            raise ValueError("invalid POLRound")
        if not self.block_id.is_complete():
            raise ValueError("expected complete BlockID")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > 64:
            raise ValueError("signature too big")

    def to_proto(self) -> bytes:
        return (pw.Writer()
                .int_field(1, self.type)
                .int_field(2, self.height)
                .int_field(3, self.round)
                .int_field(4, self.pol_round)
                .message_field(5, self.block_id.to_proto())
                .message_field(6, self.timestamp.to_proto())
                .bytes_field(7, self.signature)
                .bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "Proposal":
        r = pw.Reader(payload)
        # proto3: omitted scalars are zero (not the dataclass default -1)
        p = Proposal(pol_round=0)
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                p.type = r.read_int()
            elif f == 2:
                p.height = r.read_int()
            elif f == 3:
                p.round = r.read_int()
            elif f == 4:
                p.pol_round = r.read_int()
            elif f == 5:
                p.block_id = BlockID.from_proto(r.read_bytes())
            elif f == 6:
                p.timestamp = Timestamp.from_proto(r.read_bytes())
            elif f == 7:
                p.signature = r.read_bytes()
            else:
                r.skip(w)
        return p
