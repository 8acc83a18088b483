"""The Tendermint BFT state machine (the port's copy of
`cometbft_tpu.consensus.state`; CometBFT internal/consensus/state.go).

One event-loop thread (receive_routine) serializes everything: peer
messages, our own proposals/votes (internal queue), and timeouts. Every
message is written to the WAL before processing — internal messages
fsynced — so a crash replays to the exact pre-crash state.

Round lifecycle: NewRound -> Propose -> Prevote -> [PrevoteWait] ->
Precommit -> [PrecommitWait] -> Commit -> NewHeight, with POL-based
locking/unlocking per the Tendermint algorithm (arXiv:1807.04938).

`ConsensusState(device=)` (default "cuda") must be its BlockExecutor's
device: every block it validates (the proposal at prevote, the polka
block it locks, the block it finalizes) checks the LastCommit there,
one RLC program on K1-K4 at DEVICE_THRESHOLD signatures and more
(types/validation.verify_commit).  Without a card it raises unless
given device="cpu".  The proposal's signature and vote extensions
verify on the host, as in the JAX package; gossiped votes are
pre-verified by the reactor (consensus/reactor.py) on the vote stream.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass

_log = logging.getLogger(__name__)

from ..crypto import sigcache
from ..libs import flightrec
from ..libs import lockrank
from ..libs import trace as libtrace
from ..libs import tracetl
from ..libs.fail import fail_point
from ..libs.service import BaseService
from ..ops import device as devmod
from ..types import events as events_
from ..types.block import Block, BlockID, ExtendedCommit, PartSetHeader
from ..types.part_set import BLOCK_PART_SIZE, PartSet, PartSetError
from ..types.vote import PRECOMMIT_TYPE, PREVOTE_TYPE, Proposal, Vote
from ..types.vote_set import (
    ErrVoteConflictingVotes, VoteSet, commit_to_vote_set,
    extended_commit_to_vote_set,
)
from ..types.timestamp import Timestamp
from . import messages as msgs
from .round_types import (
    STEP_COMMIT, STEP_NEW_HEIGHT, STEP_NEW_ROUND, STEP_PRECOMMIT,
    STEP_PRECOMMIT_WAIT, STEP_PREVOTE, STEP_PREVOTE_WAIT, STEP_PROPOSE,
    STEP_NAMES, HeightVoteSet,
)
from .ticker import TimeoutTicker
from .wal import EndHeightMessage, EventRoundState, MsgInfo, TimeoutInfo

MAX_BLOCK_SIZE_BYTES = 104857600


@dataclass
class ConsensusConfig:
    """Round timeouts (CometBFT config/config.go:1163-1207)."""
    timeout_propose: float = 3.0
    timeout_propose_delta: float = 0.5
    timeout_prevote: float = 1.0
    timeout_prevote_delta: float = 0.5
    timeout_precommit: float = 1.0
    timeout_precommit_delta: float = 0.5
    timeout_commit: float = 1.0
    create_empty_blocks: bool = True
    create_empty_blocks_interval: float = 0.0

    def propose(self, round_: int) -> float:
        return self.timeout_propose + self.timeout_propose_delta * round_

    def prevote(self, round_: int) -> float:
        return self.timeout_prevote + self.timeout_prevote_delta * round_

    def precommit(self, round_: int) -> float:
        return self.timeout_precommit + \
            self.timeout_precommit_delta * round_


def test_consensus_config() -> ConsensusConfig:
    """config.TestConsensusConfig: tight timeouts for in-process tests."""
    return ConsensusConfig(
        timeout_propose=0.08, timeout_propose_delta=0.002,
        timeout_prevote=0.02, timeout_prevote_delta=0.002,
        timeout_precommit=0.02, timeout_precommit_delta=0.002,
        timeout_commit=0.02)


class ConsensusError(Exception):
    pass


class ConsensusState(BaseService):
    """internal/consensus/state.go State."""

    def __init__(self, config: ConsensusConfig, state, block_exec,
                 block_store, wal=None, priv_validator=None,
                 event_bus=None, ticker=None, evidence_pool=None,
                 mempool=None, device="cuda"):
        super().__init__("ConsensusState")
        self.device = devmod.resolve(device)
        if block_exec.device != self.device:
            raise ValueError(
                f"the executor runs on {block_exec.device}, consensus "
                f"on {self.device}")
        self.config = config
        self.block_exec = block_exec
        self.block_store = block_store
        self.wal = wal
        # optional ConsensusMetrics (libs/metrics.py), assigned by the node
        self.metrics = None
        # optional FlightRecorder (libs/flightrec.py), assigned by the
        # node wiring; None keeps every hot path a single test
        self.recorder = None
        # optional per-node Timeline (libs/tracetl.py); falls back to
        # the process-wide tracetl seam, no-op when neither is set
        self.timeline = None
        self._last_commit_monotonic = None
        self._step_start = time.monotonic()
        self._round_start = time.monotonic()
        self.priv_validator = priv_validator
        self.priv_validator_pub_key = \
            priv_validator.get_pub_key() if priv_validator else None
        self.event_bus = event_bus or events_.NopEventBus()
        self.evpool = evidence_pool
        self.mempool = mempool
        self.replay_mode = False
        self.crash_error: Exception | None = None

        # event loop plumbing
        self.peer_msg_queue: queue.Queue = queue.Queue(1000)
        self.internal_msg_queue: queue.Queue = queue.Queue(1000)
        self.timeout_queue: queue.Queue = queue.Queue(10)
        self.ticker = ticker if ticker is not None else TimeoutTicker(None)
        # the ticker tocks into our timeout queue
        if hasattr(self.ticker, "set_tock"):
            self.ticker.set_tock(self.timeout_queue.put)
        else:
            self.ticker._tock = self.timeout_queue.put
        self._wake = threading.Event()
        self._loop_thread: threading.Thread | None = None
        # observers of internal events (reactor hooks: evsw analog)
        self.listeners: list = []

        # RoundState (flattened onto self, as the reference embeds it)
        self.height = 0
        self.round = 0
        self.step = STEP_NEW_HEIGHT
        self.start_time = 0.0
        self.commit_time = 0.0
        self.validators = None
        self.proposal: Proposal | None = None
        self.proposal_receive_time: Timestamp | None = None
        self.proposal_block = None
        self.proposal_block_parts: PartSet | None = None
        self.locked_round = -1
        self.locked_block = None
        self.locked_block_parts = None
        self.valid_round = -1
        self.valid_block = None
        self.valid_block_parts = None
        self.votes: HeightVoteSet | None = None
        self.commit_round = -1
        self.last_commit: VoteSet | None = None
        self.last_validators = None
        self.triggered_timeout_precommit = False

        self.state = None  # sm.State
        self._mtx = lockrank.RankedRLock("consensus.state")

        # restart: rebuild last_commit from the stored seen commit BEFORE
        # update_to_state asserts on it (state.go NewState ordering)
        if state.last_block_height > 0:
            self.reconstruct_last_commit(state)
        self.update_to_state(state)

    # -- lifecycle ---------------------------------------------------------
    def on_start(self) -> None:
        self.ticker.start()
        self._loop_thread = threading.Thread(
            target=self._receive_routine, name="cs-receive", daemon=True)
        self._loop_thread.start()
        self.schedule_round_0()

    def on_stop(self) -> None:
        self.ticker.stop()
        # poison pill wakes the loop
        self.timeout_queue.put(None)
        if self._loop_thread is not None and \
                self._loop_thread is not threading.current_thread():
            self._loop_thread.join(timeout=5)

    # -- external input ----------------------------------------------------
    def add_peer_message(self, msg, peer_id: str) -> None:
        self.peer_msg_queue.put(MsgInfoWrapper(msg, peer_id))

    def send_internal_message(self, msg) -> None:
        self.internal_msg_queue.put(MsgInfoWrapper(msg, ""))

    def handle_txs_available(self) -> None:
        """mempool notification (state.go:1026)."""
        self.peer_msg_queue.put(TxsAvailableEvent())

    # -- event loop --------------------------------------------------------
    def _receive_routine(self) -> None:
        while self.is_running():
            item = self._next_event()
            if item is None:
                continue
            with self._mtx:
                try:
                    self._dispatch(item)
                except Exception as e:
                    if not self.is_running():
                        return
                    # fail LOUD and stop the service: a consensus crash
                    # must never degrade into silent non-participation
                    # (CometBFT panics the process, state.go:810)
                    self.crash_error = e
                    import traceback
                    traceback.print_exc()
                    threading.Thread(target=self.stop,
                                     daemon=True).start()
                    raise

    def _next_event(self, timeout: float = 0.1):
        """Timeouts first (they unblock stalls), then internal, then
        peer messages."""
        try:
            return self.timeout_queue.get_nowait()
        except queue.Empty:
            pass
        try:
            return self.internal_msg_queue.get_nowait()
        except queue.Empty:
            pass
        try:
            return self.peer_msg_queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def _dispatch(self, item) -> None:
        if isinstance(item, TimeoutInfo):
            if self.wal is not None:
                self.wal.write(timeout_wal_msg(item))
            self._handle_timeout(item)
        elif isinstance(item, TxsAvailableEvent):
            self._handle_txs_available()
        elif isinstance(item, MsgInfoWrapper):
            if self.wal is not None:
                wm = MsgInfo(peer_id=item.peer_id,
                             msg_bytes=msgs.wrap_message(item.msg))
                if item.peer_id == "":
                    self.wal.write_sync(wm)  # fsync our own msgs
                else:
                    self.wal.write(wm)
            self._handle_msg(item.msg, item.peer_id)

    def process_wal_message(self, msg, peer_id: str = "") -> None:
        """Replay one WAL message through the handlers (no re-logging)."""
        self.replay_mode = True
        try:
            with self._mtx:
                self._handle_msg(msg, peer_id)
        finally:
            self.replay_mode = False

    def _handle_msg(self, msg, peer_id: str) -> None:
        """A peer's proposal or block part that does not fit is logged
        and dropped, as CometBFT's handleMsg does (state.go): a part of
        another proposal than the one being assembled (another round's,
        or a catch-up part of a block this node has not decided on) or
        a proposal with a bad signature.  The JAX package raises there,
        and its state machine stops.  Our own messages stay fatal."""
        try:
            if isinstance(msg, msgs.ProposalMessage):
                self._set_proposal(msg.proposal, Timestamp.now())
            elif isinstance(msg, msgs.BlockPartMessage):
                added = self._add_proposal_block_part(msg, peer_id)
                if added and self.proposal_block_parts.is_complete():
                    self._handle_complete_proposal(msg.height)
            elif isinstance(msg, msgs.VoteMessage):
                self._try_add_vote(msg.vote, peer_id)
            else:
                raise ConsensusError(f"unknown msg type {type(msg)}")
        except (ConsensusError, PartSetError) as e:
            if not peer_id or not isinstance(
                    msg, (msgs.ProposalMessage, msgs.BlockPartMessage)):
                raise
            _log.debug("dropped %s from %s at %d/%d: %s",
                       type(msg).__name__, peer_id, self.height,
                       self.round, e)

    def _handle_timeout(self, ti: TimeoutInfo) -> None:
        # stale timeouts are ignored (state.go:977)
        if ti.height != self.height or ti.round < self.round or \
                (ti.round == self.round and ti.step < self.step):
            return
        if not self.replay_mode and self.recorder is not None:
            self.recorder.record(
                flightrec.EV_TIMEOUT, height=ti.height, round=ti.round,
                step=STEP_NAMES.get(ti.step, str(ti.step)))
        if ti.step == STEP_NEW_HEIGHT:
            self.enter_new_round(ti.height, 0)
        elif ti.step == STEP_NEW_ROUND:
            self.enter_propose(ti.height, 0)
        elif ti.step == STEP_PROPOSE:
            self.event_bus.publish_timeout_propose(
                self._round_state_event())
            self.enter_prevote(ti.height, ti.round)
        elif ti.step == STEP_PREVOTE_WAIT:
            self.event_bus.publish_timeout_wait(self._round_state_event())
            self.enter_precommit(ti.height, ti.round)
        elif ti.step == STEP_PRECOMMIT_WAIT:
            self.event_bus.publish_timeout_wait(self._round_state_event())
            self.enter_precommit(ti.height, ti.round)
            self.enter_new_round(ti.height, ti.round + 1)
        else:
            raise ConsensusError(f"invalid timeout step {ti.step}")

    def _handle_txs_available(self) -> None:
        """handleTxsAvailable (state.go:1026-1049): inside the
        timeout-commit phase, schedule the REMAINING commit timeout as a
        NEW_ROUND timeout (+1ms so it lands after the NEW_HEIGHT timeout
        and enter_new_round's bookkeeping has run) instead of proposing
        immediately — cutting the window short would collect fewer
        last-height precommits into the next LastCommit."""
        if self.round != 0:
            return
        if self.step == STEP_NEW_HEIGHT:
            if self._need_proof_block(self.height):
                # enter_propose will be reached via enter_new_round
                return
            remaining = max(self.start_time - time.monotonic(), 0.0)
            self._schedule_timeout(remaining + 0.001, self.height, 0,
                                   STEP_NEW_ROUND)
        elif self.step == STEP_NEW_ROUND:
            # waiting for txs inside the round (create_empty_blocks=False)
            self.enter_propose(self.height, 0)

    def _need_proof_block(self, height: int) -> bool:
        """First block, or app hash changed last height — a block must be
        proposed regardless of txs (state.go needProofBlock)."""
        if height == self.state.initial_height:
            return True
        if self.block_store is None:
            return False
        meta = self.block_store.load_block_meta(height - 1)
        return meta is None or self.state.app_hash != meta.header.app_hash

    # -- state transitions -------------------------------------------------
    def update_to_state(self, state) -> None:
        """Prepare for the next height (state.go updateToState)."""
        if self.commit_round > -1 and 0 < self.height != \
                state.last_block_height:
            raise ConsensusError(
                f"update_to_state expected height {self.height}, found "
                f"{state.last_block_height}")
        if self.state is not None and not self.state.is_empty():
            if state.last_block_height <= self.state.last_block_height:
                self._new_step()
                return

        if state.last_block_height == 0:
            self.last_commit = None
        elif self.commit_round > -1 and self.votes is not None:
            pre = self.votes.precommits(self.commit_round)
            if not pre.has_two_thirds_majority():
                raise ConsensusError(
                    "wanted to form a commit but precommits lack 2/3+")
            self.last_commit = pre
        elif self.last_commit is None:
            raise ConsensusError(
                "last commit cannot be empty after initial block")

        height = state.last_block_height + 1
        if height == 1:
            height = state.initial_height

        self.height = height
        self._update_round_step(0, STEP_NEW_HEIGHT)
        if not self.replay_mode and self.recorder is not None:
            self.recorder.record(flightrec.EV_NEW_HEIGHT, height=height)
        self._tl_instant("new_height", height=height)
        if self.commit_time == 0.0:
            self.start_time = time.monotonic() + self.config.timeout_commit
        else:
            self.start_time = self.commit_time + self.config.timeout_commit
        self.validators = state.validators
        self.proposal = None
        self.proposal_receive_time = None
        self.proposal_block = None
        self.proposal_block_parts = None
        self.locked_round = -1
        self.locked_block = None
        self.locked_block_parts = None
        self.valid_round = -1
        self.valid_block = None
        self.valid_block_parts = None
        ext = state.consensus_params.vote_extensions_enabled(height)
        self.votes = HeightVoteSet(state.chain_id, height,
                                   state.validators,
                                   extensions_enabled=ext)
        self.commit_round = -1
        self.last_validators = state.last_validators
        self.triggered_timeout_precommit = False
        self.state = state
        self._new_step()

    def reconstruct_last_commit(self, state) -> None:
        """Rebuild last_commit from the block store's seen commit
        (state.go reconstructLastCommit)."""
        self.commit_time = 0.0
        if state.last_block_height == 0 or self.block_store is None:
            return
        ext_enabled = state.consensus_params.vote_extensions_enabled(
            state.last_block_height)
        if ext_enabled:
            raw = self.block_store.load_extended_commit(
                state.last_block_height)
            if raw is None:
                raise ConsensusError(
                    "failed to reconstruct last extended commit")
            ec = raw if not isinstance(raw, (bytes, bytearray)) else \
                ExtendedCommit.from_proto(raw)
            self.last_commit = extended_commit_to_vote_set(
                state.chain_id, ec, state.last_validators)
        else:
            commit = self.block_store.load_seen_commit(
                state.last_block_height)
            if commit is None or commit.height != state.last_block_height:
                raise ConsensusError(
                    f"failed to reconstruct last commit; commit for height "
                    f"{state.last_block_height} not found")
            self.last_commit = commit_to_vote_set(
                state.chain_id, commit, state.last_validators)
        if not self.last_commit.has_two_thirds_majority():
            raise ConsensusError(
                "failed to reconstruct last commit; no +2/3")

    def schedule_round_0(self) -> None:
        sleep = max(self.start_time - time.monotonic(), 0.0)
        self._schedule_timeout(sleep, self.height, 0, STEP_NEW_HEIGHT)

    def _schedule_timeout(self, duration_s: float, height: int,
                          round_: int, step: int) -> None:
        self.ticker.schedule_timeout(TimeoutInfo(
            duration_ns=int(duration_s * 1e9), height=height,
            round=round_, step=step))

    def _tl_instant(self, name: str, **fields) -> None:
        """Timeline point event (libs/tracetl.py): per-node instance if
        the wiring assigned one, else the process-wide seam; free when
        neither is set and skipped in WAL replay like the recorder."""
        if self.replay_mode:
            return
        tl = self.timeline if self.timeline is not None \
            else tracetl.timeline()
        if tl is not None:
            tl.instant("consensus", name, **fields)

    def _update_round_step(self, round_: int, step: int) -> None:
        """Every round/step transition funnels through here — the one
        place step_duration / round_duration / the flight recorder see
        the timeline (CometBFT state.go updateRoundStep with
        metrics.MarkStep / MarkRound)."""
        now = time.monotonic()
        if not self.replay_mode:
            # round 0 re-entry at a new height counts as a new round
            new_round = round_ != self.round or \
                (round_ == 0 and step == STEP_NEW_ROUND)
            m = self.metrics
            if m is not None:
                if step != self.step:
                    m.step_duration_seconds.labels(
                        STEP_NAMES.get(self.step, str(self.step))
                    ).observe(now - self._step_start)
                if new_round:
                    m.round_duration_seconds.observe(
                        now - self._round_start)
            if step != self.step:
                self._step_start = now
            if new_round:
                self._round_start = now
            rec = self.recorder
            if rec is not None and (round_ != self.round
                                    or step != self.step):
                rec.record(flightrec.EV_STEP, height=self.height,
                           round=round_,
                           step=STEP_NAMES.get(step, str(step)))
            if round_ != self.round or step != self.step:
                self._tl_instant("step", height=self.height,
                                 round=round_,
                                 step=STEP_NAMES.get(step, str(step)))
        self.round = round_
        self.step = step

    def _new_step(self) -> None:
        if self.wal is not None:
            self.wal.write(EventRoundState(
                height=self.height, round=self.round,
                step=STEP_NAMES.get(self.step, "")))
        self.event_bus.publish_new_round_step(self._round_state_event())
        self._notify_listeners("new_round_step")

    def _round_state_event(self) -> events_.EventDataRoundState:
        return events_.EventDataRoundState(
            height=self.height, round=self.round,
            step=STEP_NAMES.get(self.step, ""))

    def _notify_listeners(self, kind: str, data=None) -> None:
        for fn in self.listeners:
            fn(kind, self, data)

    # enterNewRound(height, round): state.go:1063
    def enter_new_round(self, height: int, round_: int) -> None:
        if self.height != height or round_ < self.round or \
                (self.round == round_ and self.step != STEP_NEW_HEIGHT):
            return

        validators = self.validators
        if self.round < round_:
            validators = validators.copy()
            validators.increment_proposer_priority(round_ - self.round)

        self.validators = validators
        if self.metrics is not None:
            self.metrics.rounds.set(round_)
        if round_ > 0 and not self.replay_mode and \
                self.recorder is not None:
            # the timeline that led here is exactly what the recorder
            # exists to answer — dump it on the first escalation
            self.recorder.record(flightrec.EV_ESCALATION,
                                 height=height, round=round_)
            if round_ == 1:
                self.recorder.dump_to_log(
                    f"height {height} escalated past round 0", _log)
        if round_ != 0:
            # round catchup: clear the proposal from the earlier round
            self.proposal = None
            self.proposal_receive_time = None
            self.proposal_block = None
            self.proposal_block_parts = None
        self._update_round_step(round_, STEP_NEW_ROUND)
        self.votes.set_round(round_ + 1)  # track next-round votes too
        self.triggered_timeout_precommit = False

        proposer = self.validators.get_proposer()
        self.event_bus.publish_new_round(events_.EventDataNewRound(
            height=height, round=round_, step=STEP_NAMES[self.step],
            proposer_address=proposer.address if proposer else b""))

        wait_for_txs = (not self.config.create_empty_blocks and
                        round_ == 0 and self.mempool is not None and
                        self.mempool.size() == 0 and
                        not self._need_proof_block(height))
        if wait_for_txs:
            if self.config.create_empty_blocks_interval > 0:
                self._schedule_timeout(
                    self.config.create_empty_blocks_interval, height,
                    round_, STEP_NEW_ROUND)
            self.mempool.enable_txs_available()
        else:
            self.enter_propose(height, round_)

    # enterPropose: state.go:1152
    def enter_propose(self, height: int, round_: int) -> None:
        if self.height != height or round_ < self.round or \
                (self.round == round_ and self.step >= STEP_PROPOSE):
            return

        try:
            # schedule prevote-on-timeout before anything can block
            self._schedule_timeout(self.config.propose(round_), height,
                                   round_, STEP_PROPOSE)

            if self.priv_validator is None or \
                    self.priv_validator_pub_key is None:
                return
            addr = self.priv_validator_pub_key.address()
            if not self.validators.has_address(addr):
                return
            if self._is_proposer(addr):
                with libtrace.span("consensus", "propose"), \
                        tracetl.span_for(self, "consensus", "propose",
                                         height=height, round=round_):
                    self._decide_proposal(height, round_)
        finally:
            self._update_round_step(round_, STEP_PROPOSE)
            self._new_step()
            if self._is_proposal_complete():
                self.enter_prevote(height, self.round)

    def _is_proposer(self, address: bytes) -> bool:
        proposer = self.validators.get_proposer()
        return proposer is not None and proposer.address == address

    def _decide_proposal(self, height: int, round_: int) -> None:
        """defaultDecideProposal (state.go:1226)."""
        if self.valid_block is not None:
            block, block_parts = self.valid_block, self.valid_block_parts
        else:
            block = self._create_proposal_block()
            if block is None:
                return
            block_parts = PartSet.from_data(block.to_proto(),
                                            BLOCK_PART_SIZE)

        if self.wal is not None:
            self.wal.flush_and_sync()

        prop_block_id = BlockID(block.hash(), block_parts.header)
        proposal = Proposal(height=height, round=round_,
                            pol_round=self.valid_round,
                            block_id=prop_block_id,
                            timestamp=block.header.time)
        try:
            self.priv_validator.sign_proposal(self.state.chain_id,
                                              proposal)
        except Exception:
            return

        self.send_internal_message(msgs.ProposalMessage(proposal))
        for i in range(block_parts.header.total):
            part = block_parts.get_part(i)
            self.send_internal_message(
                msgs.BlockPartMessage(self.height, self.round, part))

    def _create_proposal_block(self):
        if self.height == self.state.initial_height:
            last_ext_commit = ExtendedCommit()
        elif self.last_commit is not None and \
                self.last_commit.has_two_thirds_majority():
            last_ext_commit = self.last_commit.make_extended_commit(
                self.state.consensus_params.vote_extensions_enabled(
                    self.height - 1))
        else:
            return None
        return self.block_exec.create_proposal_block(
            self.height, self.state, last_ext_commit,
            self.priv_validator_pub_key.address())

    def _is_proposal_complete(self) -> bool:
        if self.proposal is None or self.proposal_block is None:
            return False
        if self.proposal.pol_round < 0:
            return True
        pv = self.votes.prevotes(self.proposal.pol_round)
        return pv is not None and pv.has_two_thirds_majority()

    # enterPrevote: state.go:1345
    def enter_prevote(self, height: int, round_: int) -> None:
        if self.height != height or round_ < self.round or \
                (self.round == round_ and self.step >= STEP_PREVOTE):
            return
        try:
            with libtrace.span("consensus", "prevote"), \
                    tracetl.span_for(self, "consensus", "prevote",
                                     height=height, round=round_):
                self._do_prevote(height, round_)
        finally:
            self._update_round_step(round_, STEP_PREVOTE)
            self._new_step()

    def _mark_proposal(self, status: str) -> None:
        """proposal_receive_count{status}: the prevote-time verdict on
        the proposal (CometBFT MarkProposalProcessed)."""
        if self.metrics is not None and not self.replay_mode:
            self.metrics.proposal_receive_count.labels(status).inc()

    def _do_prevote(self, height: int, round_: int) -> None:
        """defaultDoPrevote (state.go:1387)."""
        if self.proposal is None or self.proposal_block is None:
            self._sign_add_vote(PREVOTE_TYPE, b"", PartSetHeader())
            return

        block_hash = self.proposal_block.hash()

        if self.proposal.pol_round == -1:
            if self.locked_round == -1:
                if self.valid_round != -1 and self.valid_block is not None \
                        and block_hash == self.valid_block.hash():
                    self._sign_add_vote(
                        PREVOTE_TYPE, block_hash,
                        self.proposal_block_parts.header)
                    return
                # PBTS: the proposal timestamp must equal the block time
                # and be timely w.r.t. our receive time and the chain's
                # SynchronyParams (CometBFT state.go:1438-1463); without
                # this a byzantine proposer poisons BFT time.
                if self.state.consensus_params.pbts_enabled(height):
                    if self.proposal.timestamp != \
                            self.proposal_block.header.time:
                        self._mark_proposal("rejected")
                        self._sign_add_vote(PREVOTE_TYPE, b"",
                                            PartSetHeader())
                        return
                    if not self._proposal_is_timely():
                        self._mark_proposal("rejected")
                        self._sign_add_vote(PREVOTE_TYPE, b"",
                                            PartSetHeader())
                        return
                # consensus-level validity
                try:
                    with sigcache.consumer("consensus"):
                        self.block_exec.validate_block(self.state,
                                                       self.proposal_block)
                except Exception:
                    self._mark_proposal("rejected")
                    self._sign_add_vote(PREVOTE_TYPE, b"",
                                        PartSetHeader())
                    return
                # app-level validity
                if not self.block_exec.process_proposal(
                        self.proposal_block, self.state):
                    self._mark_proposal("rejected")
                    self._sign_add_vote(PREVOTE_TYPE, b"",
                                        PartSetHeader())
                    return
                self._mark_proposal("accepted")
                self._sign_add_vote(PREVOTE_TYPE, block_hash,
                                    self.proposal_block_parts.header)
                return
            if self.locked_block is not None and \
                    block_hash == self.locked_block.hash():
                self._sign_add_vote(PREVOTE_TYPE, block_hash,
                                    self.proposal_block_parts.header)
                return
            self._sign_add_vote(PREVOTE_TYPE, b"", PartSetHeader())
            return

        # POLRound >= 0: proposer claims a prior POL (state.go:1520)
        pv = self.votes.prevotes(self.proposal.pol_round)
        block_id, ok = pv.two_thirds_majority() if pv else (None, False)
        ok = ok and not block_id.is_nil()
        if ok and block_hash == block_id.hash and \
                self.proposal.pol_round < self.round:
            if (self.locked_round < self.proposal.pol_round
                    or (self.locked_block is not None
                        and block_hash == self.locked_block.hash())
                    or self.locked_round == self.proposal.pol_round):
                self._sign_add_vote(PREVOTE_TYPE, block_hash,
                                    self.proposal_block_parts.header)
                return
        self._sign_add_vote(PREVOTE_TYPE, b"", PartSetHeader())

    def _proposal_is_timely(self) -> bool:
        """PBTS timeliness (types/proposal.go:97 IsTimely with the
        per-round message-delay relaxation of params.go InRound):
        ts - precision <= recv <= ts + message_delay*1.1**round + precision.
        """
        sp = self.state.consensus_params.synchrony
        delay_ns = int((1.1 ** self.proposal.round) * sp.message_delay_ns)
        if self.proposal_receive_time is None:
            return False
        diff = self.proposal_receive_time.diff_ns(self.proposal.timestamp)
        return -sp.precision_ns <= diff <= delay_ns + sp.precision_ns

    def enter_prevote_wait(self, height: int, round_: int) -> None:
        if self.height != height or round_ < self.round or \
                (self.round == round_ and self.step >= STEP_PREVOTE_WAIT):
            return
        if not self.votes.prevotes(round_).has_two_thirds_any():
            raise ConsensusError(
                "enter_prevote_wait without any +2/3 prevotes")
        self._update_round_step(round_, STEP_PREVOTE_WAIT)
        self._new_step()
        self._schedule_timeout(self.config.prevote(round_), height,
                               round_, STEP_PREVOTE_WAIT)

    # enterPrecommit: state.go:1609
    def enter_precommit(self, height: int, round_: int) -> None:
        if self.height != height or round_ < self.round or \
                (self.round == round_ and self.step >= STEP_PRECOMMIT):
            return
        try:
            with libtrace.span("consensus", "precommit"), \
                    tracetl.span_for(self, "consensus", "precommit",
                                     height=height, round=round_):
                self._do_precommit(height, round_)
        finally:
            self._update_round_step(round_, STEP_PRECOMMIT)
            self._new_step()

    def _do_precommit(self, height: int, round_: int) -> None:
        block_id, ok = self.votes.prevotes(round_).two_thirds_majority()

        if not ok:  # no polka: precommit nil
            self._sign_add_vote(PRECOMMIT_TYPE, b"", PartSetHeader())
            return

        self.event_bus.publish_polka(self._round_state_event())

        pol_round, _ = self.votes.pol_info()
        if pol_round < round_:
            raise ConsensusError(
                f"POLRound should be {round_} but got {pol_round}")

        if block_id.is_nil():  # +2/3 prevoted nil
            self._sign_add_vote(PRECOMMIT_TYPE, b"", PartSetHeader())
            return

        if self.locked_block is not None and \
                self.locked_block.hash() == block_id.hash:
            # relock
            self.locked_round = round_
            self.event_bus.publish_relock(self._round_state_event())
            self._sign_add_vote(PRECOMMIT_TYPE, block_id.hash,
                                block_id.part_set_header,
                                block=self.locked_block)
            return

        if self.proposal_block is not None and \
                self.proposal_block.hash() == block_id.hash:
            # lock onto the polka block
            with sigcache.consumer("consensus"):
                self.block_exec.validate_block(self.state,
                                               self.proposal_block)
            self.locked_round = round_
            self.locked_block = self.proposal_block
            self.locked_block_parts = self.proposal_block_parts
            self.event_bus.publish_lock(self._round_state_event())
            self._sign_add_vote(PRECOMMIT_TYPE, block_id.hash,
                                block_id.part_set_header,
                                block=self.proposal_block)
            return

        # polka for a block we don't have: fetch it, precommit nil
        if self.proposal_block_parts is None or \
                self.proposal_block_parts.header != \
                block_id.part_set_header:
            self.proposal_block = None
            self.proposal_block_parts = PartSet.new_from_header(
                block_id.part_set_header)
        self._sign_add_vote(PRECOMMIT_TYPE, b"", PartSetHeader())

    def enter_precommit_wait(self, height: int, round_: int) -> None:
        if self.height != height or round_ < self.round or \
                (self.round == round_ and self.triggered_timeout_precommit):
            return
        if not self.votes.precommits(round_).has_two_thirds_any():
            raise ConsensusError(
                "enter_precommit_wait without any +2/3 precommits")
        self.triggered_timeout_precommit = True
        self._new_step()
        self._schedule_timeout(self.config.precommit(round_), height,
                               round_, STEP_PRECOMMIT_WAIT)

    # enterCommit: state.go:1743
    def enter_commit(self, height: int, commit_round: int) -> None:
        if self.height != height or self.step >= STEP_COMMIT:
            return
        try:
            block_id, ok = self.votes.precommits(
                commit_round).two_thirds_majority()
            if not ok or block_id.is_nil():
                raise ConsensusError(
                    "enter_commit expects +2/3 precommits for a block")

            if self.locked_block is not None and \
                    self.locked_block.hash() == block_id.hash:
                self.proposal_block = self.locked_block
                self.proposal_block_parts = self.locked_block_parts

            if self.proposal_block is None or \
                    self.proposal_block.hash() != block_id.hash:
                if self.proposal_block_parts is None or \
                        self.proposal_block_parts.header != \
                        block_id.part_set_header:
                    # wrong block: set up to receive the right one
                    self.proposal_block = None
                    self.proposal_block_parts = PartSet.new_from_header(
                        block_id.part_set_header)
                    self.event_bus.publish_valid_block(
                        self._round_state_event())
                    self._notify_listeners("valid_block")
        finally:
            self._update_round_step(self.round, STEP_COMMIT)
            self.commit_round = commit_round
            self.commit_time = time.monotonic()
            self._new_step()
            self.try_finalize_commit(height)

    def try_finalize_commit(self, height: int) -> None:
        if self.height != height:
            raise ConsensusError("try_finalize_commit height mismatch")
        block_id, ok = self.votes.precommits(
            self.commit_round).two_thirds_majority()
        if not ok or block_id.is_nil():
            return
        if self.proposal_block is None or \
                self.proposal_block.hash() != block_id.hash:
            return  # don't have the block yet
        self._finalize_commit(height)

    def _finalize_commit(self, height: int) -> None:
        if self.height != height or self.step != STEP_COMMIT:
            return
        with libtrace.span("consensus", "commit"), \
                tracetl.span_for(self, "consensus", "commit",
                                 height=height):
            self._do_finalize_commit(height)

    def _do_finalize_commit(self, height: int) -> None:
        """state.go:1834: save -> WAL EndHeight (fsync) -> apply -> next
        height. The ordering is the crash-recovery contract."""
        block_id, ok = self.votes.precommits(
            self.commit_round).two_thirds_majority()
        block, block_parts = self.proposal_block, self.proposal_block_parts
        if not ok or not block_parts or \
                block_parts.header != block_id.part_set_header or \
                block.hash() != block_id.hash:
            raise ConsensusError("cannot finalize commit: inconsistent")

        # LastCommit triples were already verified live by the streaming
        # pre-verifier; with the verdict cache on, this re-validation is
        # all hits (labelled "consensus" for CacheMetrics attribution).
        with sigcache.consumer("consensus"):
            self.block_exec.validate_block(self.state, block)

        fail_point("cs-before-save-block")

        if self.block_store.height() < block.header.height:
            ext_enabled = self.state.consensus_params \
                .vote_extensions_enabled(block.header.height)
            seen_ec = self.votes.precommits(
                self.commit_round).make_extended_commit(ext_enabled)
            self.block_store.save_block(
                block, block_parts, seen_ec.to_commit(),
                ext_commit=seen_ec.to_proto() if ext_enabled else None)

        fail_point("cs-before-wal-endheight")

        if self.wal is not None:
            self.wal.write_sync(EndHeightMessage(height))

        fail_point("cs-after-wal-endheight")

        state_copy = self.state.copy()
        state_copy = self.block_exec.apply_verified_block(
            state_copy,
            BlockID(block.hash(), block_parts.header),
            block, block.header.height)

        fail_point("cs-after-apply")

        # timeline: the height's proposal->commit window closes here —
        # the block is saved, WAL'd, and applied on THIS node
        self._tl_instant("commit", height=block.header.height)

        if self.metrics is not None:
            m = self.metrics
            m.height.set(block.header.height)
            m.num_txs.set(len(block.data.txs))
            m.block_size_bytes.set(len(block.to_proto()))
            m.total_txs.add(len(block.data.txs))
            m.validators.set(len(self.validators.validators))
            m.validators_power.set(self.validators.total_voting_power())
            if self._last_commit_monotonic is not None:
                m.block_interval_seconds.observe(
                    time.monotonic() - self._last_commit_monotonic)
            self._last_commit_monotonic = time.monotonic()

        self.update_to_state(state_copy)

        # The validator key might have rotated.  With a remote signer
        # this is a network round trip and may transiently fail — never
        # let it stall consensus (CometBFT logs and keeps the old
        # key, state.go updatePrivValidatorPubKey).
        if self.priv_validator is not None:
            try:
                self.priv_validator_pub_key = \
                    self.priv_validator.get_pub_key()
            except Exception as e:
                _log.warning("failed to refresh privval pub key: %s", e)

        self.schedule_round_0()

    # -- proposals ---------------------------------------------------------
    def _set_proposal(self, proposal: Proposal,
                      recv_time: Timestamp) -> None:
        """defaultSetProposal (state.go:2048)."""
        if self.proposal is not None or proposal is None:
            return
        if proposal.height != self.height or \
                proposal.round != self.round:
            return
        if proposal.pol_round < -1 or (
                0 <= proposal.pol_round >= proposal.round):
            raise ConsensusError("invalid proposal POLRound")

        proposer = self.validators.get_proposer()
        if not proposer.pub_key.verify_signature(
                proposal.sign_bytes(self.state.chain_id),
                proposal.signature):
            raise ConsensusError("invalid proposal signature")

        max_bytes = self.state.consensus_params.block.max_bytes
        if max_bytes == -1:
            max_bytes = MAX_BLOCK_SIZE_BYTES
        if proposal.block_id.part_set_header.total > \
                (max_bytes - 1) // BLOCK_PART_SIZE + 1:
            raise ConsensusError("proposal has too many parts")

        self.proposal = proposal
        self.proposal_receive_time = recv_time
        if self.proposal_block_parts is None:
            self.proposal_block_parts = PartSet.new_from_header(
                proposal.block_id.part_set_header)
        if not self.replay_mode and self.recorder is not None:
            self.recorder.record(
                flightrec.EV_PROPOSAL, height=proposal.height,
                round=proposal.round, pol_round=proposal.pol_round)
        # timeline: the height's proposal->commit window opens at the
        # EARLIEST of these instants across the cluster
        self._tl_instant("proposal", height=proposal.height,
                         round=proposal.round)
        self._notify_listeners("proposal", proposal)

    def _add_proposal_block_part(self, msg: msgs.BlockPartMessage,
                                 peer_id: str) -> bool:
        """state.go:2123."""
        if self.height != msg.height:
            return False
        if self.proposal_block_parts is None:
            return False

        added = self.proposal_block_parts.add_part(msg.part)
        if not added:
            return False

        max_bytes = self.state.consensus_params.block.max_bytes
        if max_bytes == -1:
            max_bytes = MAX_BLOCK_SIZE_BYTES
        if self.proposal_block_parts.byte_size > max_bytes:
            raise ConsensusError("block parts exceed max block bytes")

        if self.proposal_block_parts.is_complete():
            data = self.proposal_block_parts.assemble()
            self.proposal_block = Block.from_proto(data)
            self.event_bus.publish_complete_proposal(
                events_.EventDataCompleteProposal(
                    height=self.height, round=self.round,
                    step=STEP_NAMES.get(self.step, ""),
                    block_id=BlockID(self.proposal_block.hash(),
                                     self.proposal_block_parts.header)))
            self._notify_listeners("block_part", msg)
        else:
            self._notify_listeners("block_part", msg)
        return added

    def _handle_complete_proposal(self, height: int) -> None:
        """state.go:2207."""
        prevotes = self.votes.prevotes(self.round)
        block_id, has_two_thirds = prevotes.two_thirds_majority() \
            if prevotes else (None, False)
        if has_two_thirds and not block_id.is_nil() and \
                self.valid_round < self.round:
            if self.proposal_block.hash() == block_id.hash:
                self.valid_round = self.round
                self.valid_block = self.proposal_block
                self.valid_block_parts = self.proposal_block_parts

        if self.step <= STEP_PROPOSE and self._is_proposal_complete():
            self.enter_prevote(height, self.round)
            if has_two_thirds:
                self.enter_precommit(height, self.round)
        elif self.step == STEP_COMMIT:
            self.try_finalize_commit(height)

    # -- votes -------------------------------------------------------------
    def _try_add_vote(self, vote: Vote, peer_id: str) -> bool:
        """state.go:2243: conflicting votes become evidence."""
        try:
            return self._add_vote(vote, peer_id)
        except ErrVoteConflictingVotes as e:
            if self.priv_validator_pub_key is not None and \
                    vote.validator_address == \
                    self.priv_validator_pub_key.address():
                # we equivocated?! do not process further
                raise ConsensusError(
                    "found conflicting vote from ourselves") from e
            if self.evpool is not None:
                self.evpool.report_conflicting_votes(e.vote_a, e.vote_b)
            return False
        except Exception:
            return False

    _VOTE_TYPE_NAMES = {PREVOTE_TYPE: "prevote",
                        PRECOMMIT_TYPE: "precommit"}

    def _record_vote(self, vote: Vote, late: bool) -> None:
        """Vote-arrival observability: lateness counter + one flight
        recorder event per vote (cheap: a lock and a ring store)."""
        if self.replay_mode:
            return
        tname = self._VOTE_TYPE_NAMES.get(vote.type, str(vote.type))
        if late and self.metrics is not None:
            self.metrics.late_votes.labels(tname).inc()
        if self.recorder is not None:
            self.recorder.record(
                flightrec.EV_VOTE, height=vote.height, round=vote.round,
                type=tname, index=vote.validator_index, late=late)

    def _count_duplicate_vote(self) -> None:
        if self.metrics is not None and not self.replay_mode:
            self.metrics.duplicate_vote_count.inc()

    def _add_vote(self, vote: Vote, peer_id: str) -> bool:
        """state.go:2294."""
        self._record_vote(
            vote, late=vote.height < self.height or
            (vote.height == self.height and vote.round < self.round))
        # precommit for the previous height (during commit timeout)
        if vote.height + 1 == self.height and \
                vote.type == PRECOMMIT_TYPE:
            if self.step != STEP_NEW_HEIGHT:
                return False
            added = False
            if self.last_commit is not None:
                added = self.last_commit.add_vote(vote)
                if not added:
                    self._count_duplicate_vote()
            if added:
                self.event_bus.publish_vote(events_.EventDataVote(vote))
                self._notify_listeners("vote", vote)
            return added

        if vote.height != self.height:
            return False

        ext_enabled = self.state.consensus_params \
            .vote_extensions_enabled(vote.height)
        if ext_enabled:
            my_addr = self.priv_validator_pub_key.address() \
                if self.priv_validator_pub_key else None
            if vote.type == PRECOMMIT_TYPE and not vote.block_id.is_nil() \
                    and vote.validator_address != my_addr:
                _, val = self.state.validators.get_by_index(
                    vote.validator_index)
                if not val.pub_key.verify_signature(
                        vote.extension_sign_bytes(self.state.chain_id),
                        vote.extension_signature):
                    return False
                if not self.block_exec.verify_vote_extension(vote):
                    return False
        elif vote.extension or vote.extension_signature:
            return False

        height = self.height
        added = self.votes.add_vote(vote, peer_id)
        if not added:
            self._count_duplicate_vote()
            return False

        self.event_bus.publish_vote(events_.EventDataVote(vote))
        self._notify_listeners("vote", vote)

        if vote.type == PREVOTE_TYPE:
            self._on_prevote_added(vote, height)
        elif vote.type == PRECOMMIT_TYPE:
            self._on_precommit_added(vote, height)
        return True

    def _on_prevote_added(self, vote: Vote, height: int) -> None:
        prevotes = self.votes.prevotes(vote.round)

        block_id, ok = prevotes.two_thirds_majority()
        if self.metrics is not None and not self.replay_mode and \
                self.proposal is not None and vote.round == self.round:
            # seconds from the proposal timestamp to the prevote quorum
            # arriving / to the full prevote set arriving (reference
            # quorum_prevote_delay / full_prevote_delay gauges) — the
            # number that says whether slow rounds wait on gossip or on
            # verification
            if ok:
                self.metrics.quorum_prevote_delay.set(
                    Timestamp.now().diff_ns(self.proposal.timestamp)
                    / 1e9)
            if all(v is not None for v in prevotes.votes):
                self.metrics.full_prevote_delay.set(
                    Timestamp.now().diff_ns(self.proposal.timestamp)
                    / 1e9)
        if ok and not block_id.is_nil():
            # update valid block on POL
            if self.valid_round < vote.round and vote.round == self.round:
                if self.proposal_block is not None and \
                        self.proposal_block.hash() == block_id.hash:
                    self.valid_round = vote.round
                    self.valid_block = self.proposal_block
                    self.valid_block_parts = self.proposal_block_parts
                else:
                    self.proposal_block = None
                if self.proposal_block_parts is None or \
                        self.proposal_block_parts.header != \
                        block_id.part_set_header:
                    self.proposal_block_parts = PartSet.new_from_header(
                        block_id.part_set_header)
                self.event_bus.publish_valid_block(
                    self._round_state_event())
                self._notify_listeners("valid_block")

        if self.round < vote.round and prevotes.has_two_thirds_any():
            self.enter_new_round(height, vote.round)
        elif self.round == vote.round and self.step >= STEP_PREVOTE:
            block_id, ok = prevotes.two_thirds_majority()
            if ok and (self._is_proposal_complete() or block_id.is_nil()):
                self.enter_precommit(height, vote.round)
            elif prevotes.has_two_thirds_any():
                self.enter_prevote_wait(height, vote.round)
        elif self.proposal is not None and \
                0 <= self.proposal.pol_round == vote.round:
            if self._is_proposal_complete():
                self.enter_prevote(height, self.round)

    def _on_precommit_added(self, vote: Vote, height: int) -> None:
        precommits = self.votes.precommits(vote.round)
        block_id, ok = precommits.two_thirds_majority()
        if ok:
            self.enter_new_round(height, vote.round)
            self.enter_precommit(height, vote.round)
            if not block_id.is_nil():
                self.enter_commit(height, vote.round)
            else:
                self.enter_precommit_wait(height, vote.round)
        elif self.round <= vote.round and \
                precommits.has_two_thirds_any():
            self.enter_new_round(height, vote.round)
            self.enter_precommit_wait(height, vote.round)

    # -- signing -----------------------------------------------------------
    def _vote_time(self, height: int) -> Timestamp:
        """BFT time: strictly after the reference block time
        (state.go voteTime)."""
        now = Timestamp.now()
        min_time = now
        ref_block = self.locked_block or self.proposal_block
        if ref_block is not None:
            min_time = ref_block.header.time.add_ns(1_000_000)  # +1ms
        if now.diff_ns(min_time) > 0:
            return now
        return min_time

    def _sign_vote(self, msg_type: int, hash_: bytes,
                   header: PartSetHeader, block=None) -> Vote | None:
        if self.wal is not None:
            self.wal.flush_and_sync()
        if self.priv_validator_pub_key is None:
            return None
        addr = self.priv_validator_pub_key.address()
        val_idx, _ = self.validators.get_by_address(addr)
        vote = Vote(
            type=msg_type, height=self.height, round=self.round,
            block_id=BlockID(hash_, header),
            timestamp=self._vote_time(self.height),
            validator_address=addr, validator_index=val_idx)
        ext_enabled = self.state.consensus_params \
            .vote_extensions_enabled(vote.height)
        if msg_type == PRECOMMIT_TYPE and not vote.block_id.is_nil() \
                and ext_enabled:
            vote.extension = self.block_exec.extend_vote(
                vote, block, self.state)
        self.priv_validator.sign_vote(
            self.state.chain_id, vote,
            sign_extension=ext_enabled and msg_type == PRECOMMIT_TYPE)
        return vote

    def _sign_add_vote(self, msg_type: int, hash_: bytes,
                       header: PartSetHeader, block=None) -> None:
        if self.priv_validator is None or \
                self.priv_validator_pub_key is None:
            return
        if not self.validators.has_address(
                self.priv_validator_pub_key.address()):
            return
        try:
            vote = self._sign_vote(msg_type, hash_, header, block)
        except Exception as e:
            # NEVER fatal (CometBFT state.go signAddVote logs and
            # returns).  During WAL catchup the FilePV rightly refuses
            # to re-sign steps it already signed — the pre-crash vote's
            # effect is replayed from the WAL's own VoteMessage.
            _log.log(logging.DEBUG if self.replay_mode else logging.ERROR,
                     "failed signing vote at %d/%d: %s",
                     self.height, self.round, e)
            return
        if vote is not None:
            self.send_internal_message(msgs.VoteMessage(vote))


@dataclass
class MsgInfoWrapper:
    """In-memory queue item (decoded msg + origin peer)."""
    msg: object
    peer_id: str


class TxsAvailableEvent:
    pass


def timeout_wal_msg(ti: TimeoutInfo) -> TimeoutInfo:
    return ti
