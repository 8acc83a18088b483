"""VoteSet: signature tally per (height, round, type) (the port's copy
of `cometbft_tpu.types.vote_set`; CometBFT types/vote_set.go).

Tracks the canonical vote per validator plus per-block tallies so
conflicting (equivocating) votes are detected but memory stays bounded:
a conflicting vote is only retained when some peer claimed a 2/3
majority for that block.  add_vote consumes a streaming pre-verification
(crypto/votestream.Preverified) when it covers exactly the triple it
would verify, and otherwise verifies inline through Vote.verify (the
verdict cache, then the host); make_commit builds the commit that
types/validation.verify_commit_light checks at the next height.
"""

from __future__ import annotations

from ..libs.bits import BitArray
from .block import (
    BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL,
    BlockID, Commit, ExtendedCommit, ExtendedCommitSig,
)
from .validator_set import ValidatorSet
from .vote import PRECOMMIT_TYPE, Vote

# vote_set.go:17 MaxVotesCount — DoS bound, implies a validator limit
MAX_VOTES_COUNT = 10000


class VoteSetError(Exception):
    pass


class ErrVoteUnexpectedStep(VoteSetError):
    pass


class ErrVoteInvalidValidatorIndex(VoteSetError):
    pass


class ErrVoteInvalidValidatorAddress(VoteSetError):
    pass


class ErrVoteInvalidSignature(VoteSetError):
    pass


class ErrVoteNonDeterministicSignature(VoteSetError):
    pass


class ErrVoteConflictingVotes(VoteSetError):
    def __init__(self, conflicting: Vote, new: Vote):
        super().__init__("conflicting votes from validator "
                         f"{new.validator_address.hex()}")
        self.vote_a = conflicting
        self.vote_b = new


class _BlockVotes:
    """Votes for one block key (vote_set.go blockVotes)."""

    __slots__ = ("peer_maj23", "bit_array", "votes", "sum")

    def __init__(self, peer_maj23: bool, n: int):
        self.peer_maj23 = peer_maj23
        self.bit_array = BitArray(n)
        self.votes: list[Vote | None] = [None] * n
        self.sum = 0

    def add_verified_vote(self, vote: Vote, power: int) -> None:
        i = vote.validator_index
        if self.votes[i] is None:
            self.bit_array.set_index(i, True)
            self.votes[i] = vote
            self.sum += power

    def get_by_index(self, i: int) -> Vote | None:
        return self.votes[i]


class VoteSet:
    def __init__(self, chain_id: str, height: int, round_: int,
                 signed_msg_type: int, val_set: ValidatorSet,
                 extensions_enabled: bool = False):
        if height == 0:
            raise ValueError("cannot make VoteSet for height 0")
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.signed_msg_type = signed_msg_type
        self.val_set = val_set
        self.extensions_enabled = extensions_enabled

        n = val_set.size()
        self.votes_bit_array = BitArray(n)
        self.votes: list[Vote | None] = [None] * n
        self.sum = 0
        self.maj23: BlockID | None = None
        self.votes_by_block: dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: dict[str, BlockID] = {}

    def size(self) -> int:
        return self.val_set.size()

    # -- adding votes ------------------------------------------------------
    def add_vote(self, vote: Vote | None) -> bool:
        """True if the vote is valid and new; False for exact duplicates.
        Raises VoteSetError subclasses otherwise (vote_set.go:158)."""
        if vote is None:
            raise VoteSetError("nil vote")
        val_index = vote.validator_index
        val_addr = vote.validator_address
        block_key = vote.block_id.key()

        if val_index < 0:
            raise ErrVoteInvalidValidatorIndex("index < 0")
        if not val_addr:
            raise ErrVoteInvalidValidatorAddress("empty address")
        if (vote.height != self.height or vote.round != self.round
                or vote.type != self.signed_msg_type):
            raise ErrVoteUnexpectedStep(
                f"expected {self.height}/{self.round}/"
                f"{self.signed_msg_type}, got {vote.height}/"
                f"{vote.round}/{vote.type}")

        lookup_addr, val = self.val_set.get_by_index(val_index)
        if val is None:
            raise ErrVoteInvalidValidatorIndex(
                f"cannot find validator {val_index} in valSet of size "
                f"{self.val_set.size()}")
        if lookup_addr != val_addr:
            raise ErrVoteInvalidValidatorAddress(
                f"vote address {val_addr.hex()} does not match validator "
                f"{val_index}")

        existing = self._get_vote(val_index, block_key)
        if existing is not None:
            if existing.signature == vote.signature:
                return False  # duplicate
            raise ErrVoteNonDeterministicSignature(
                "same vote signed differently")

        # signature check (the per-vote hot path; vote_set.go:219-232).
        # A reactor-attached streaming pre-verification is consumed iff
        # it covers EXACTLY the (pubkey, sign-bytes, sig) we would check
        # ourselves (crypto/votestream); otherwise verify inline.
        try:
            verdict = None
            if vote.preverified is not None:
                verdict = vote.preverified.verdict_for(
                    val.pub_key.bytes(), vote.sign_bytes(self.chain_id),
                    vote.signature)
                vote.preverified = None    # release buffers + future
            if verdict is False:
                raise ValueError("invalid signature")
            if verdict is True:
                if val.pub_key.address() != vote.validator_address:
                    raise ValueError("invalid validator address")
                if self.extensions_enabled:
                    vote.verify_extension_signature(
                        self.chain_id, val.pub_key)
            elif self.extensions_enabled:
                vote.verify_vote_and_extension(self.chain_id, val.pub_key)
            else:
                vote.verify(self.chain_id, val.pub_key)
        except ValueError as e:
            raise ErrVoteInvalidSignature(str(e)) from e
        if not self.extensions_enabled and (vote.extension
                                            or vote.extension_signature):
            raise VoteSetError("unexpected vote extension data")

        added, conflicting = self._add_verified_vote(
            vote, block_key, val.voting_power)
        if conflicting is not None:
            raise ErrVoteConflictingVotes(conflicting, vote)
        if not added:
            raise VoteSetError("expected to add non-conflicting vote")
        return True

    def _get_vote(self, val_index: int, block_key: bytes) -> Vote | None:
        existing = self.votes[val_index]
        if existing is not None and existing.block_id.key() == block_key:
            return existing
        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            return bv.get_by_index(val_index)
        return None

    def _add_verified_vote(self, vote: Vote, block_key: bytes, power: int
                           ) -> tuple[bool, Vote | None]:
        val_index = vote.validator_index
        conflicting = None

        existing = self.votes[val_index]
        if existing is not None:
            conflicting = existing
            # replace only if this vote is for the known maj23 block
            if self.maj23 is not None and self.maj23.key() == block_key:
                self.votes[val_index] = vote
                self.votes_bit_array.set_index(val_index, True)
        else:
            self.votes[val_index] = vote
            self.votes_bit_array.set_index(val_index, True)
            self.sum += power

        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            if conflicting is not None and not bv.peer_maj23:
                return False, conflicting
        else:
            if conflicting is not None:
                # not tracking this block: forget the conflicting vote
                return False, conflicting
            bv = _BlockVotes(False, self.val_set.size())
            self.votes_by_block[block_key] = bv

        orig_sum = bv.sum
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        bv.add_verified_vote(vote, power)

        if orig_sum < quorum <= bv.sum and self.maj23 is None:
            self.maj23 = vote.block_id
            for i, v in enumerate(bv.votes):
                if v is not None:
                    self.votes[i] = v
        return True, conflicting

    # -- peer claims -------------------------------------------------------
    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """A peer claims +2/3 for block_id: start tracking conflicting
        votes for it (vote_set.go:335)."""
        block_key = block_id.key()
        existing = self.peer_maj23s.get(peer_id)
        if existing is not None:
            if existing == block_id:
                return
            raise VoteSetError(
                f"conflicting maj23 claim from peer {peer_id}")
        self.peer_maj23s[peer_id] = block_id

        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            bv.peer_maj23 = True
        else:
            self.votes_by_block[block_key] = _BlockVotes(
                True, self.val_set.size())

    # -- queries -----------------------------------------------------------
    def bit_array(self) -> BitArray:
        return self.votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> BitArray | None:
        bv = self.votes_by_block.get(block_id.key())
        return bv.bit_array.copy() if bv is not None else None

    def get_by_index(self, val_index: int) -> Vote | None:
        if val_index < 0 or val_index >= len(self.votes):
            return None
        return self.votes[val_index]

    def get_by_address(self, address: bytes) -> Vote | None:
        idx, val = self.val_set.get_by_address(address)
        if val is None:
            return None
        return self.votes[idx]

    def list(self) -> list[Vote]:
        return [v for v in self.votes if v is not None]

    def has_two_thirds_majority(self) -> bool:
        return self.maj23 is not None

    def is_commit(self) -> bool:
        return (self.signed_msg_type == PRECOMMIT_TYPE
                and self.maj23 is not None)

    def has_two_thirds_any(self) -> bool:
        return self.sum > self.val_set.total_voting_power() * 2 // 3

    def has_all(self) -> bool:
        return self.sum == self.val_set.total_voting_power()

    def two_thirds_majority(self) -> tuple[BlockID, bool]:
        if self.maj23 is not None:
            return self.maj23, True
        return BlockID(), False

    # -- commit construction ----------------------------------------------
    def make_extended_commit(self, ext_enabled: bool) -> ExtendedCommit:
        """Commit with extensions from +2/3 precommits (vote_set.go:633)."""
        if self.signed_msg_type != PRECOMMIT_TYPE:
            raise VoteSetError("not a precommit VoteSet")
        if self.maj23 is None:
            raise VoteSetError("no +2/3 majority")
        sigs = []
        for v in self.votes:
            sig = _extended_commit_sig(v)
            if sig.block_id_flag == BLOCK_ID_FLAG_COMMIT and \
                    v.block_id != self.maj23:
                sig = ExtendedCommitSig.absent()
            sigs.append(sig)
        ec = ExtendedCommit(self.height, self.round, self.maj23, sigs)
        ec.ensure_extensions(ext_enabled)
        return ec

    def make_commit(self) -> Commit:
        return self.make_extended_commit(False).to_commit()


def _extended_commit_sig(v: Vote | None) -> ExtendedCommitSig:
    """vote.go ExtendedCommitSig: absent / nil / commit flag from the
    vote's BlockID."""
    if v is None:
        return ExtendedCommitSig.absent()
    if v.block_id.is_nil():
        flag = BLOCK_ID_FLAG_NIL
    else:
        flag = BLOCK_ID_FLAG_COMMIT
    return ExtendedCommitSig(flag, v.validator_address, v.timestamp,
                             v.signature, v.extension,
                             v.extension_signature)


def commit_to_vote_set(chain_id: str, commit: Commit,
                       val_set: ValidatorSet) -> VoteSet:
    """Rebuild a (verified) VoteSet from a Commit (block.go
    CommitToVoteSet) — used by consensus catch-up from seen commits."""
    vs = VoteSet(chain_id, commit.height, commit.round, PRECOMMIT_TYPE,
                 val_set)
    for idx, cs in enumerate(commit.signatures):
        if cs.block_id_flag == BLOCK_ID_FLAG_ABSENT:
            continue
        vote = Vote(
            type=PRECOMMIT_TYPE, height=commit.height, round=commit.round,
            block_id=cs.block_id(commit.block_id), timestamp=cs.timestamp,
            validator_address=cs.validator_address, validator_index=idx,
            signature=cs.signature)
        vs.add_vote(vote)
    return vs


def extended_commit_to_vote_set(chain_id: str, ec: ExtendedCommit,
                                val_set: ValidatorSet) -> VoteSet:
    """block.go:1103 ToExtendedVoteSet."""
    vs = VoteSet(chain_id, ec.height, ec.round, PRECOMMIT_TYPE, val_set,
                 extensions_enabled=True)
    for idx, s in enumerate(ec.extended_signatures):
        if s.block_id_flag == BLOCK_ID_FLAG_ABSENT:
            continue
        if s.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            bid = ec.block_id
        else:
            bid = BlockID()
        vote = Vote(
            type=PRECOMMIT_TYPE, height=ec.height, round=ec.round,
            block_id=bid, timestamp=s.timestamp,
            validator_address=s.validator_address, validator_index=idx,
            signature=s.signature, extension=s.extension,
            extension_signature=s.extension_signature)
        vs.add_vote(vote)
    return vs
