"""Consensus gossip reactor (the port's copy of
`cometbft_tpu.consensus.reactor`; CometBFT internal/consensus/reactor.go).

Four p2p channels: State 0x20 (round-step/has-vote/maj23 metadata),
Data 0x21 (proposals + block parts), Vote 0x22, VoteSetBits 0x23.
Per peer: a PeerState mirror of the peer's round state plus three
routines — gossip_data (proposal/parts/catchup blocks), gossip_votes
(votes the peer is missing, chosen from its bit arrays), query_maj23.
Our own step changes/votes surface through ConsensusState.listeners and
are broadcast as NewRoundStep / NewValidBlock / HasVote.

Every gossiped vote is submitted to the streaming verifier
(crypto/votestream.py) as it arrives, off the state thread: a flush of
the verifier's device_threshold votes or more is one window on the
verify pipeline's consensus lane (the RLC program on K1-K4; K1 + K14
localize a reject), and VoteSet.add_vote consumes the verdict.  A vote
that arrives while the state thread holds its lock is not submitted,
and VoteSet verifies it inline on the host.  `vote_paths` counts both.

`ConsensusReactor(device=)` (default "cuda") must be the consensus
state's device; the verifier is `verifier=`, or the process-wide
default_verifier on that device.  Without a card it raises unless given
device="cpu".  Each peer's three gossip routines stop and are joined
when the peer is removed or the reactor stops.
"""

from __future__ import annotations

import collections
import threading
import time

from ..libs import lockrank
from ..libs import tracetl
from ..libs.bits import BitArray
from ..p2p.base_reactor import Envelope, Reactor
from ..p2p.conn.connection import ChannelDescriptor
from ..types.block import BLOCK_ID_FLAG_ABSENT, PartSetHeader
from ..types.vote import PRECOMMIT_TYPE, PREVOTE_TYPE, Vote
from . import messages as msgs
from .round_types import STEP_COMMIT, STEP_PROPOSE

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23

PEER_GOSSIP_SLEEP = 0.1        # reactor.go peerGossipSleepDuration
PEER_QUERY_MAJ23_SLEEP = 2.0


class PeerState:
    """Mirror of a peer's round state (reactor.go:1114)."""

    def __init__(self, peer):
        self.peer = peer
        self.mtx = lockrank.RankedRLock("consensus.peerstate")
        # PeerRoundState (internal/consensus/types/peer_round_state.go)
        self.height = 0
        self.round = -1
        self.step = 0
        self.proposal = False
        self.proposal_block_part_set_header = PartSetHeader()
        self.proposal_block_parts: BitArray | None = None
        self.proposal_pol_round = -1
        self.proposal_pol: BitArray | None = None
        self.prevotes: BitArray | None = None
        self.precommits: BitArray | None = None
        self.last_commit_round = -1
        self.last_commit: BitArray | None = None
        self.catchup_commit_round = -1
        self.catchup_commit: BitArray | None = None

    # -- updates from peer messages ---------------------------------------
    def apply_new_round_step(self, m: msgs.NewRoundStepMessage) -> None:
        with self.mtx:
            # ignore duplicates and decreases (reactor.go CompareHRS)
            if (m.height, m.round, m.step) <= \
                    (self.height, self.round, self.step):
                return
            # capture BEFORE the reset: the peer's last-commit bits are
            # its previous-round precommits (reactor.go:1239-1255)
            prev_round = self.round
            prev_precommits = self.precommits
            new_height = m.height != self.height
            self.height = m.height
            self.round = m.round
            self.step = m.step
            if new_height or m.round != prev_round:
                self.proposal = False
                self.proposal_block_part_set_header = PartSetHeader()
                self.proposal_block_parts = None
                self.proposal_pol_round = -1
                self.proposal_pol = None
                self.prevotes = None
                self.precommits = None
            if new_height:
                if m.last_commit_round != -1 and \
                        prev_round == m.last_commit_round:
                    self.last_commit = prev_precommits
                else:
                    self.last_commit = None
                self.last_commit_round = m.last_commit_round
                self.catchup_commit_round = -1
                self.catchup_commit = None

    def apply_new_valid_block(self, m: msgs.NewValidBlockMessage) -> None:
        with self.mtx:
            if self.height != m.height:
                return
            if self.round != m.round and not m.is_commit:
                return
            self.proposal_block_part_set_header = m.block_part_set_header
            self.proposal_block_parts = m.block_parts

    def set_has_proposal(self, proposal) -> None:
        with self.mtx:
            if self.height != proposal.height or \
                    self.round != proposal.round:
                return
            if self.proposal:
                return
            self.proposal = True
            if self.proposal_block_parts is not None:
                return  # already set by NewValidBlock
            self.proposal_block_part_set_header = \
                proposal.block_id.part_set_header
            self.proposal_block_parts = BitArray(
                proposal.block_id.part_set_header.total)
            self.proposal_pol_round = proposal.pol_round
            self.proposal_pol = None

    def set_has_proposal_block_part(self, height: int, round_: int,
                                    index: int) -> None:
        with self.mtx:
            if self.height != height or self.round != round_:
                return
            if self.proposal_block_parts is None:
                self.proposal_block_parts = BitArray(index + 1)
            self.proposal_block_parts.set_index(index, True)

    def apply_proposal_pol(self, m: msgs.ProposalPOLMessage) -> None:
        with self.mtx:
            if self.height != m.height:
                return
            if self.proposal_pol_round != m.proposal_pol_round:
                return
            self.proposal_pol = m.proposal_pol

    def apply_has_vote(self, m: msgs.HasVoteMessage) -> None:
        self.set_has_vote(m.height, m.round, m.type, m.index)

    def apply_vote_set_bits(self, m: msgs.VoteSetBitsMessage,
                            our_votes: BitArray | None) -> None:
        with self.mtx:
            ba = self._get_vote_bit_array(m.height, m.round, m.type)
            if ba is not None and m.votes is not None:
                if our_votes is None:
                    ba.update(m.votes)
                else:
                    # (votes & our_votes) | (ba & ~our_votes)
                    merged = m.votes.and_(our_votes).or_(
                        ba.sub(our_votes))
                    ba.update(merged)

    def set_has_vote(self, height: int, round_: int, vote_type: int,
                     index: int) -> None:
        with self.mtx:
            ba = self._get_vote_bit_array(height, round_, vote_type)
            if ba is not None:
                ba.set_index(index, True)

    def _get_vote_bit_array(self, height: int, round_: int,
                            vote_type: int) -> BitArray | None:
        if self.height == height:
            if self.round == round_:
                ba = self.prevotes if vote_type == PREVOTE_TYPE \
                    else self.precommits
                if ba is not None:
                    return ba
            if self.catchup_commit_round == round_ and \
                    vote_type == PRECOMMIT_TYPE:
                return self.catchup_commit
            if self.proposal_pol_round == round_ and \
                    vote_type == PREVOTE_TYPE:
                return self.proposal_pol
        elif self.height == height + 1:
            if self.last_commit_round == round_ and \
                    vote_type == PRECOMMIT_TYPE:
                return self.last_commit
        return None

    def ensure_vote_bit_arrays(self, height: int, n_vals: int) -> None:
        with self.mtx:
            if self.height == height:
                if self.prevotes is None:
                    self.prevotes = BitArray(n_vals)
                if self.precommits is None:
                    self.precommits = BitArray(n_vals)
                if self.catchup_commit is None:
                    self.catchup_commit = BitArray(n_vals)
                if self.proposal_pol is None:
                    self.proposal_pol = BitArray(n_vals)
            elif self.height == height + 1:
                if self.last_commit is None:
                    self.last_commit = BitArray(n_vals)

    def ensure_catchup_commit_round(self, height: int, round_: int,
                                    n_vals: int) -> None:
        with self.mtx:
            if self.height != height:
                return
            if self.catchup_commit_round == round_:
                return
            self.catchup_commit_round = round_
            self.catchup_commit = BitArray(n_vals)

    def pick_vote_to_send(self, vote_set) -> object | None:
        """A vote from vote_set the peer hasn't seen (reactor.go
        PickVoteToSend)."""
        if vote_set is None or vote_set.size() == 0:
            return None
        with self.mtx:
            ps_votes = self._get_vote_bit_array(
                vote_set.height, vote_set.round, vote_set.signed_msg_type)
            if ps_votes is None:
                return None
            missing = vote_set.bit_array().sub(ps_votes)
            idx, ok = missing.pick_random()
            if not ok:
                return None
            return vote_set.get_by_index(idx)


class ConsensusReactor(Reactor):
    def __init__(self, consensus_state, wait_sync: bool = False,
                 device="cuda", verifier=None):
        from ..ops import device as devmod

        super().__init__("ConsensusReactor")
        self.device = devmod.resolve(device)
        if consensus_state.device != self.device:
            raise ValueError(
                f"consensus runs on {consensus_state.device}, the reactor "
                f"on {self.device}")
        vdev = getattr(verifier, "device", None)
        if vdev is not None and vdev != self.device:
            raise ValueError(f"the verifier runs on {vdev}, the reactor "
                             f"on {self.device}")
        self.cs = consensus_state
        self.wait_sync = wait_sync  # blocksync first; flip via switch_to_consensus
        # the streaming verifier; None = votestream.default_verifier on
        # the reactor's device, made at the first vote
        self.verifier = verifier
        # incoming votes by what _preverify_vote did with them: "stream"
        # (submitted), "busy" (the state lock was held), "seen" (a copy
        # of a vote the set already holds), "skip" (another height, a
        # non-ed25519 key, no signature, an unknown validator)
        self.vote_paths = collections.Counter()
        self._peer_states: dict[str, PeerState] = {}
        self._peer_stops: dict[str, threading.Event] = {}
        self._peer_threads: dict[str, list] = {}
        # optional per-node Timeline (libs/tracetl.py): gossip sends
        # mint trace contexts and receives record the causal edge
        self.timeline = None
        self.cs.listeners.append(self._on_internal_event)

    def _send_ctx(self, height: int, round_: int, kind: str):
        """Mint + record a trace context for one gossip send; None
        (and free) when no timeline is installed."""
        tl = self.timeline if self.timeline is not None \
            else tracetl.timeline()
        if tl is None:
            return None
        ctx = tl.ctx(height, round_)
        tl.send("consensus", kind, ctx)
        return ctx

    # -- reactor API -------------------------------------------------------
    def get_channels(self) -> list:
        return [
            ChannelDescriptor(STATE_CHANNEL, priority=6,
                              send_queue_capacity=100),
            ChannelDescriptor(DATA_CHANNEL, priority=10,
                              send_queue_capacity=100),
            ChannelDescriptor(VOTE_CHANNEL, priority=7,
                              send_queue_capacity=100),
            ChannelDescriptor(VOTE_SET_BITS_CHANNEL, priority=1,
                              send_queue_capacity=2),
        ]

    def on_start(self) -> None:
        if not self.wait_sync:
            self.cs.start()

    def on_stop(self) -> None:
        for stop in list(self._peer_stops.values()):
            stop.set()
        self.cs.stop()
        for threads in list(self._peer_threads.values()):
            for t in threads:
                if t is not threading.current_thread():
                    t.join(timeout=5)

    # -- vote pre-verification (SURVEY §7 streaming accumulator) -----------
    def _preverify_vote(self, vote, tctx=None) -> None:
        """Submit the vote's signature to the streaming verifier off the
        state thread; VoteSet.add_vote consumes the verdict iff the
        (pubkey, sign_bytes, sig) triple matches what it would verify
        itself (CometBFT: the per-vote verify at
        types/vote_set.go:219 — here it is pipelined with gossip)."""
        from ..crypto.votestream import Preverified, default_verifier

        try:
            cs = self.cs
            # non-blocking: if the state thread holds the lock (e.g. mid
            # finalize), skip — pre-verification is an optimization and
            # VoteSet verifies inline anyway
            if not cs._mtx.acquire(blocking=False):
                self.vote_paths["busy"] += 1
                return
            try:
                chain_id = cs.state.chain_id
                if vote.height == cs.height:
                    vals = cs.validators
                    # duplicate gossip copies: add_vote rejects them
                    # before verifying — don't verify them here either
                    vs = cs.votes._get_vote_set(vote.round, vote.type) \
                        if cs.votes is not None else None
                    if vs is not None and 0 <= vote.validator_index < \
                            len(vs.votes) and \
                            vs.votes[vote.validator_index] is not None:
                        self.vote_paths["seen"] += 1
                        return
                elif vote.height == cs.height - 1:
                    vals = cs.last_validators
                else:
                    self.vote_paths["skip"] += 1
                    return
                if vals is None or not (
                        0 <= vote.validator_index < vals.size()):
                    self.vote_paths["skip"] += 1
                    return
                pub = vals.validators[vote.validator_index].pub_key
            finally:
                cs._mtx.release()
            if pub.type() != "ed25519" or not vote.signature:
                self.vote_paths["skip"] += 1
                return
            pk = pub.bytes()
            msg = vote.sign_bytes(chain_id)
            if tctx is None:
                # no wire context: mint a local one so the verify flush
                # still cross-references by height/round
                tl = self.timeline if self.timeline is not None \
                    else tracetl.timeline()
                if tl is not None:
                    tctx = tracetl.make_ctx(tl.node, vote.height,
                                            vote.round, 0)
            verifier = self.verifier if self.verifier is not None \
                else default_verifier(self.device)
            fut = verifier.submit(pk, msg, vote.signature, ctx=tctx)
            vote.preverified = Preverified(pk, msg, vote.signature, fut)
            self.vote_paths["stream"] += 1
        except Exception:
            return       # pre-verification is best-effort; VoteSet re-checks

    def switch_to_consensus(self, state, skip_wal: bool = False) -> None:
        """Blocksync -> consensus handoff (reactor.go:116)."""
        if state.last_block_height > 0:
            self.cs.reconstruct_last_commit(state)
        self.cs.update_to_state(state)
        self.wait_sync = False
        self.cs.start()

    def init_peer(self, peer):
        ps = PeerState(peer)
        self._peer_states[peer.id] = ps
        peer.set("consensus_peer_state", ps)
        return peer

    def add_peer(self, peer) -> None:
        ps = self._peer_states[peer.id]
        stop = threading.Event()
        self._peer_stops[peer.id] = stop
        threads = []
        for fn, tag in ((self._gossip_data_routine, "data"),
                        (self._gossip_votes_routine, "votes"),
                        (self._query_maj23_routine, "maj23")):
            t = threading.Thread(target=fn, args=(peer, ps, stop),
                                 name=f"cs-{tag}-{peer.id[:8]}",
                                 daemon=True)
            t.start()
            threads.append(t)
        self._peer_threads[peer.id] = threads
        # tell the new peer where we are
        peer.send(STATE_CHANNEL,
                  msgs.wrap_message(self._new_round_step_message()))

    def remove_peer(self, peer, reason) -> None:
        stop = self._peer_stops.pop(peer.id, None)
        if stop is not None:
            stop.set()
        self._peer_states.pop(peer.id, None)
        for t in self._peer_threads.pop(peer.id, []):
            if t is not threading.current_thread():
                t.join(timeout=5)

    _CHANNEL_KINDS = {STATE_CHANNEL: "state", DATA_CHANNEL: "data",
                      VOTE_CHANNEL: "vote",
                      VOTE_SET_BITS_CHANNEL: "vote_set_bits"}

    # -- incoming ----------------------------------------------------------
    def receive(self, envelope: Envelope) -> None:
        msg = msgs.unwrap_message(bytes(envelope.message))
        peer = envelope.src
        ps: PeerState | None = self._peer_states.get(peer.id) \
            if peer else None
        if ps is None:
            return
        ch = envelope.channel_id
        if envelope.tctx is not None:
            tl = self.timeline if self.timeline is not None \
                else tracetl.timeline()
            if tl is not None:
                # the flow edge's receiving end; message-type precision
                # comes from the paired send event (same ctx id)
                tl.recv("consensus", self._CHANNEL_KINDS.get(ch, "msg"),
                        envelope.tctx)

        if ch == STATE_CHANNEL:
            if isinstance(msg, msgs.NewRoundStepMessage):
                msg.validate_basic()
                ps.apply_new_round_step(msg)
            elif isinstance(msg, msgs.NewValidBlockMessage):
                ps.apply_new_valid_block(msg)
            elif isinstance(msg, msgs.HasVoteMessage):
                ps.apply_has_vote(msg)
            elif isinstance(msg, msgs.VoteSetMaj23Message):
                self._handle_vote_set_maj23(peer, ps, msg)
        elif ch == DATA_CHANNEL:
            if self.wait_sync:
                return
            if isinstance(msg, msgs.ProposalMessage):
                ps.set_has_proposal(msg.proposal)
                self.cs.add_peer_message(msg, peer.id)
            elif isinstance(msg, msgs.ProposalPOLMessage):
                ps.apply_proposal_pol(msg)
            elif isinstance(msg, msgs.BlockPartMessage):
                ps.set_has_proposal_block_part(msg.height, msg.round,
                                               msg.part.index)
                self.cs.add_peer_message(msg, peer.id)
        elif ch == VOTE_CHANNEL:
            if self.wait_sync:
                return
            if isinstance(msg, msgs.VoteMessage):
                with self.cs._mtx:
                    height = self.cs.height
                    val_size = self.cs.validators.size() \
                        if self.cs.validators else 0
                    last_size = self.cs.last_validators.size() \
                        if self.cs.last_validators else 0
                ps.ensure_vote_bit_arrays(height, val_size)
                ps.ensure_vote_bit_arrays(height - 1, last_size)
                v = msg.vote
                ps.set_has_vote(v.height, v.round, v.type,
                                v.validator_index)
                self._preverify_vote(v, tctx=envelope.tctx)
                self.cs.add_peer_message(msg, peer.id)
        elif ch == VOTE_SET_BITS_CHANNEL:
            if isinstance(msg, msgs.VoteSetBitsMessage):
                with self.cs._mtx:
                    if self.cs.height == msg.height and \
                            self.cs.votes is not None:
                        vs = self.cs.votes.prevotes(msg.round) \
                            if msg.type == PREVOTE_TYPE \
                            else self.cs.votes.precommits(msg.round)
                        ours = vs.bit_array_by_block_id(msg.block_id) \
                            if vs else None
                    else:
                        ours = None
                ps.apply_vote_set_bits(msg, ours)

    def _handle_vote_set_maj23(self, peer, ps: PeerState,
                               msg: msgs.VoteSetMaj23Message) -> None:
        """reactor.go:290-334: record the claim, reply with our bits."""
        with self.cs._mtx:
            if self.cs.height != msg.height or self.cs.votes is None:
                return
            try:
                self.cs.votes.set_peer_maj23(msg.round, msg.type,
                                             peer.id, msg.block_id)
            except Exception:
                return
            vs = self.cs.votes.prevotes(msg.round) \
                if msg.type == PREVOTE_TYPE \
                else self.cs.votes.precommits(msg.round)
            ours = vs.bit_array_by_block_id(msg.block_id) if vs else None
        peer.try_send(VOTE_SET_BITS_CHANNEL, msgs.wrap_message(
            msgs.VoteSetBitsMessage(msg.height, msg.round, msg.type,
                                    msg.block_id, ours)))

    # -- broadcasts from our own state machine ----------------------------
    def _on_internal_event(self, kind: str, cs, data) -> None:
        if self.switch is None:
            return
        if kind == "new_round_step":
            self.switch.try_broadcast(
                STATE_CHANNEL,
                msgs.wrap_message(self._new_round_step_message()))
        elif kind == "valid_block":
            with cs._mtx:
                if cs.proposal_block_parts is None:
                    return
                m = msgs.NewValidBlockMessage(
                    cs.height, cs.round,
                    cs.proposal_block_parts.header,
                    BitArray.from_bools(
                        cs.proposal_block_parts.bit_array()),
                    cs.step == STEP_COMMIT)
            self.switch.try_broadcast(STATE_CHANNEL, msgs.wrap_message(m))
        elif kind == "vote":
            vote = data
            self.switch.try_broadcast(STATE_CHANNEL, msgs.wrap_message(
                msgs.HasVoteMessage(vote.height, vote.round, vote.type,
                                    vote.validator_index)))

    def _new_round_step_message(self) -> msgs.NewRoundStepMessage:
        cs = self.cs
        with cs._mtx:
            lcr = -1
            if cs.last_commit is not None:
                lcr = cs.last_commit.round
            return msgs.NewRoundStepMessage(
                height=cs.height, round=cs.round, step=cs.step,
                seconds_since_start_time=max(
                    int(time.monotonic() - cs.start_time), 0),
                last_commit_round=lcr)

    # -- gossip routines ---------------------------------------------------
    def _gossip_data_routine(self, peer, ps: PeerState,
                             stop: threading.Event) -> None:
        """reactor.go:590."""
        cs = self.cs
        while not stop.is_set() and self.is_running():
            with cs._mtx:
                rs_height = cs.height
                rs_round = cs.round
                proposal = cs.proposal
                parts = cs.proposal_block_parts
            with ps.mtx:
                prs_height, prs_round = ps.height, ps.round
                prs_has_proposal = ps.proposal
                prs_parts = ps.proposal_block_parts
                prs_psh = ps.proposal_block_part_set_header

            # peer is on an earlier height: feed catchup parts from store
            if 0 < prs_height < rs_height and \
                    cs.block_store.base() <= prs_height <= \
                    cs.block_store.height():
                if self._gossip_catchup_part(peer, ps, prs_height):
                    continue
                stop.wait(PEER_GOSSIP_SLEEP)
                continue

            if rs_height != prs_height or rs_round != prs_round:
                stop.wait(PEER_GOSSIP_SLEEP)
                continue

            # send a block part the peer is missing
            if parts is not None and prs_parts is not None and \
                    parts.header == prs_psh:
                have = BitArray.from_bools(parts.bit_array())
                missing = have.sub(prs_parts)
                idx, ok = missing.pick_random()
                if ok:
                    part = parts.get_part(idx)
                    m = msgs.BlockPartMessage(rs_height, rs_round, part)
                    if peer.send(DATA_CHANNEL, msgs.wrap_message(m),
                                 tctx=self._send_ctx(rs_height, rs_round,
                                                     "block_part")):
                        ps.set_has_proposal_block_part(rs_height,
                                                       rs_round, idx)
                    continue

            # send the proposal itself
            if proposal is not None and not prs_has_proposal:
                if peer.send(DATA_CHANNEL, msgs.wrap_message(
                        msgs.ProposalMessage(proposal)),
                        tctx=self._send_ctx(proposal.height,
                                            proposal.round, "proposal")):
                    ps.set_has_proposal(proposal)
                if proposal.pol_round >= 0:
                    with cs._mtx:
                        pol = cs.votes.prevotes(proposal.pol_round)
                        pol_bits = pol.bit_array() if pol else None
                    if pol_bits is not None:
                        peer.send(DATA_CHANNEL, msgs.wrap_message(
                            msgs.ProposalPOLMessage(
                                rs_height, proposal.pol_round,
                                pol_bits)))
                continue

            stop.wait(PEER_GOSSIP_SLEEP)

    def _gossip_catchup_part(self, peer, ps: PeerState,
                             prs_height: int) -> bool:
        """Send one block part for a height the peer is catching up on
        (reactor.go gossipDataForCatchup)."""
        meta = self.cs.block_store.load_block_meta(prs_height)
        if meta is None:
            return False
        with ps.mtx:
            if ps.proposal_block_parts is None:
                # init from the stored header (reactor.go
                # InitProposalBlockParts)
                ps.proposal_block_part_set_header = \
                    meta.block_id.part_set_header
                ps.proposal_block_parts = BitArray(
                    meta.block_id.part_set_header.total)
            prs_parts = ps.proposal_block_parts
            prs_psh = ps.proposal_block_part_set_header
            prs_round = ps.round
        if meta.block_id.part_set_header != prs_psh:
            return False
        have = BitArray(prs_psh.total)
        have.bits[:] = True
        missing = have.sub(prs_parts)
        idx, ok = missing.pick_random()
        if not ok:
            return False
        part = self.cs.block_store.load_block_part(prs_height, idx)
        if part is None:
            return False
        m = msgs.BlockPartMessage(prs_height, prs_round, part)
        if peer.send(DATA_CHANNEL, msgs.wrap_message(m),
                     tctx=self._send_ctx(prs_height, prs_round,
                                         "block_part")):
            ps.set_has_proposal_block_part(prs_height, prs_round, idx)
            return True
        return False

    def _gossip_votes_routine(self, peer, ps: PeerState,
                              stop: threading.Event) -> None:
        """reactor.go:646."""
        cs = self.cs
        while not stop.is_set() and self.is_running():
            sent = False
            with cs._mtx:
                rs_height = cs.height
                votes = cs.votes
                last_commit = cs.last_commit
                val_size = cs.validators.size() if cs.validators else 0
                last_val_size = cs.last_validators.size() \
                    if cs.last_validators else 0
            with ps.mtx:
                prs_height = ps.height
                prs_round = ps.round
                prs_step = ps.step
                prs_lc_round = ps.last_commit_round
            ps.ensure_vote_bit_arrays(rs_height, val_size)
            ps.ensure_vote_bit_arrays(rs_height - 1, last_val_size)

            if rs_height == prs_height and votes is not None:
                # same height: prevotes/precommits for the peer's round
                sent = self._pick_send_vote(
                    peer, ps, votes.prevotes(prs_round)) or \
                    self._pick_send_vote(
                        peer, ps, votes.precommits(prs_round))
                if not sent and prs_step == STEP_PROPOSE and \
                        prs_round != -1:
                    with ps.mtx:
                        pol_round = ps.proposal_pol_round
                    if pol_round >= 0:
                        sent = self._pick_send_vote(
                            peer, ps, votes.prevotes(pol_round))
            if not sent and rs_height == prs_height + 1 and \
                    last_commit is not None and prs_lc_round != -1:
                # peer finishing the previous height
                sent = self._pick_send_vote(peer, ps, last_commit)
            if not sent and 0 < prs_height < rs_height and \
                    prs_height >= cs.block_store.base():
                # catchup: votes from the stored seen commit
                commit = cs.block_store.load_seen_commit(prs_height)
                if commit is not None:
                    sent = self._send_commit_vote(peer, ps, commit,
                                                  prs_height)
            if not sent:
                stop.wait(PEER_GOSSIP_SLEEP)

    def _pick_send_vote(self, peer, ps: PeerState, vote_set) -> bool:
        vote = ps.pick_vote_to_send(vote_set)
        if vote is None:
            return False
        if peer.send(VOTE_CHANNEL,
                     msgs.wrap_message(msgs.VoteMessage(vote)),
                     tctx=self._send_ctx(vote.height, vote.round,
                                         "vote")):
            ps.set_has_vote(vote.height, vote.round, vote.type,
                            vote.validator_index)
            return True
        return False

    def _send_commit_vote(self, peer, ps: PeerState, commit,
                          height: int) -> bool:
        """Turn one stored CommitSig into a vote for a lagging peer."""
        ps.ensure_catchup_commit_round(height, commit.round,
                                       len(commit.signatures))
        with ps.mtx:
            ba = ps._get_vote_bit_array(height, commit.round,
                                        PRECOMMIT_TYPE)
            if ba is None:
                return False
            have = BitArray.from_bools(
                [s.block_id_flag != BLOCK_ID_FLAG_ABSENT
                 for s in commit.signatures])
            missing = have.sub(ba)
            idx, ok = missing.pick_random()
        if not ok:
            return False
        cs_sig = commit.signatures[idx]
        vote = Vote(type=PRECOMMIT_TYPE, height=height,
                    round=commit.round,
                    block_id=cs_sig.block_id(commit.block_id),
                    timestamp=cs_sig.timestamp,
                    validator_address=cs_sig.validator_address,
                    validator_index=idx, signature=cs_sig.signature)
        if peer.send(VOTE_CHANNEL,
                     msgs.wrap_message(msgs.VoteMessage(vote)),
                     tctx=self._send_ctx(height, commit.round, "vote")):
            ps.set_has_vote(height, commit.round, PRECOMMIT_TYPE, idx)
            return True
        return False

    def _query_maj23_routine(self, peer, ps: PeerState,
                             stop: threading.Event) -> None:
        """reactor.go:708: tell peers about observed 2/3 majorities."""
        cs = self.cs
        while not stop.is_set() and self.is_running():
            if stop.wait(PEER_QUERY_MAJ23_SLEEP) or not self.is_running():
                return
            with cs._mtx:
                height, round_ = cs.height, cs.round
                votes = cs.votes
                if votes is None:
                    continue
                claims = []
                pv = votes.prevotes(round_)
                if pv is not None:
                    bid, ok = pv.two_thirds_majority()
                    if ok:
                        claims.append((round_, PREVOTE_TYPE, bid))
                pc = votes.precommits(round_)
                if pc is not None:
                    bid, ok = pc.two_thirds_majority()
                    if ok:
                        claims.append((round_, PRECOMMIT_TYPE, bid))
            with ps.mtx:
                same_height = ps.height == height
            if not same_height:
                continue
            for r, t, bid in claims:
                peer.try_send(STATE_CHANNEL, msgs.wrap_message(
                    msgs.VoteSetMaj23Message(height, r, t, bid)))
