"""Round state: step enum, RoundState, HeightVoteSet (the port's copy
of `cometbft_tpu.consensus.round_types`; CometBFT
internal/consensus/types/)."""

from __future__ import annotations

from dataclasses import dataclass

from ..types.block import BlockID
from ..types.timestamp import Timestamp
from ..types.validator_set import ValidatorSet
from ..types.vote import (
    PRECOMMIT_TYPE, PREVOTE_TYPE, Proposal, Vote, is_vote_type_valid,
)
from ..types.vote_set import VoteSet

# round_state.go RoundStepType
STEP_NEW_HEIGHT = 1
STEP_NEW_ROUND = 2
STEP_PROPOSE = 3
STEP_PREVOTE = 4
STEP_PREVOTE_WAIT = 5
STEP_PRECOMMIT = 6
STEP_PRECOMMIT_WAIT = 7
STEP_COMMIT = 8

STEP_NAMES = {
    STEP_NEW_HEIGHT: "RoundStepNewHeight",
    STEP_NEW_ROUND: "RoundStepNewRound",
    STEP_PROPOSE: "RoundStepPropose",
    STEP_PREVOTE: "RoundStepPrevote",
    STEP_PREVOTE_WAIT: "RoundStepPrevoteWait",
    STEP_PRECOMMIT: "RoundStepPrecommit",
    STEP_PRECOMMIT_WAIT: "RoundStepPrecommitWait",
    STEP_COMMIT: "RoundStepCommit",
}


@dataclass
class RoundState:
    """The full consensus-internal state for one height
    (round_state.go:66)."""
    height: int = 0
    round: int = 0
    step: int = STEP_NEW_HEIGHT
    start_time: float = 0.0          # wall clock for round-0 scheduling
    commit_time: float = 0.0

    validators: ValidatorSet | None = None
    proposal: Proposal | None = None
    proposal_receive_time: Timestamp | None = None
    proposal_block = None            # types.Block
    proposal_block_parts = None      # types.PartSet

    locked_round: int = -1
    locked_block = None
    locked_block_parts = None

    valid_round: int = -1
    valid_block = None
    valid_block_parts = None

    votes: "HeightVoteSet | None" = None
    commit_round: int = -1
    last_commit: VoteSet | None = None
    last_validators: ValidatorSet | None = None
    triggered_timeout_precommit: bool = False


class ErrGotVoteFromUnwantedRound(Exception):
    pass


@dataclass
class RoundVoteSet:
    prevotes: VoteSet
    precommits: VoteSet


class HeightVoteSet:
    """VoteSets for every round 0..round, plus up to 2 catchup rounds
    per peer (internal/consensus/types/height_vote_set.go)."""

    def __init__(self, chain_id: str, height: int, val_set: ValidatorSet,
                 extensions_enabled: bool = False):
        self.chain_id = chain_id
        self.extensions_enabled = extensions_enabled
        self.height = height
        self.val_set = val_set
        self.round = 0
        self.round_vote_sets: dict[int, RoundVoteSet] = {}
        self.peer_catchup_rounds: dict[str, list[int]] = {}
        self._add_round(0)

    def reset(self, height: int, val_set: ValidatorSet) -> None:
        self.height = height
        self.val_set = val_set
        self.round_vote_sets = {}
        self.peer_catchup_rounds = {}
        self._add_round(0)
        self.round = 0

    def _add_round(self, round_: int) -> None:
        if round_ in self.round_vote_sets:
            raise ValueError(f"add_round for existing round {round_}")
        prevotes = VoteSet(self.chain_id, self.height, round_,
                           PREVOTE_TYPE, self.val_set)
        precommits = VoteSet(self.chain_id, self.height, round_,
                             PRECOMMIT_TYPE, self.val_set,
                             extensions_enabled=self.extensions_enabled)
        self.round_vote_sets[round_] = RoundVoteSet(prevotes, precommits)

    def set_round(self, round_: int) -> None:
        """Track rounds up to round_ (height_vote_set.go SetRound)."""
        new_round = self.round - 1
        if self.round != 0 and round_ < new_round:
            raise ValueError("set_round() must increment the round")
        for r in range(max(new_round, 0), round_ + 1):
            if r not in self.round_vote_sets:
                self._add_round(r)
        self.round = round_

    def add_vote(self, vote: Vote, peer_id: str = "") -> bool:
        """Duplicate votes return False; unwanted catchup rounds raise
        (height_vote_set.go:131)."""
        if not is_vote_type_valid(vote.type):
            raise ValueError(f"invalid vote type {vote.type}")
        vs = self._get_vote_set(vote.round, vote.type)
        if vs is None:
            rounds = self.peer_catchup_rounds.get(peer_id, [])
            if len(rounds) >= 2:
                raise ErrGotVoteFromUnwantedRound(
                    "peer sent votes for too many unexpected rounds")
            self._add_round(vote.round)
            vs = self._get_vote_set(vote.round, vote.type)
            self.peer_catchup_rounds[peer_id] = rounds + [vote.round]
        return vs.add_vote(vote)

    def prevotes(self, round_: int) -> VoteSet | None:
        return self._get_vote_set(round_, PREVOTE_TYPE)

    def precommits(self, round_: int) -> VoteSet | None:
        return self._get_vote_set(round_, PRECOMMIT_TYPE)

    def pol_info(self) -> tuple[int, BlockID]:
        """Last round with a prevote majority, or (-1, nil)."""
        for r in range(self.round, -1, -1):
            rvs = self.prevotes(r)
            if rvs is not None:
                block_id, ok = rvs.two_thirds_majority()
                if ok:
                    return r, block_id
        return -1, BlockID()

    def _get_vote_set(self, round_: int, vote_type: int) -> VoteSet | None:
        rvs = self.round_vote_sets.get(round_)
        if rvs is None:
            return None
        if vote_type == PREVOTE_TYPE:
            return rvs.prevotes
        if vote_type == PRECOMMIT_TYPE:
            return rvs.precommits
        raise ValueError(f"unexpected vote type {vote_type}")

    def set_peer_maj23(self, round_: int, vote_type: int, peer_id: str,
                      block_id: BlockID) -> None:
        if not is_vote_type_valid(vote_type):
            raise ValueError(f"invalid vote type {vote_type}")
        vs = self._get_vote_set(round_, vote_type)
        if vs is not None:
            vs.set_peer_maj23(peer_id, block_id)
