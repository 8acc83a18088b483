"""Blocksync reactor (the port's copy of `cometbft_tpu.blocksync.reactor`;
CometBFT internal/blocksync/reactor.go).

Channel 0x40. Serves stored blocks to catching-up peers; when started
in sync mode, drives a BlockPool and applies downloaded blocks after
verifying each with the NEXT block's LastCommit (`verify_commit_light`,
reactor.go:546).  The LastCommits of a window of up to VERIFY_WINDOW
blocks collect into one DeferredSigBatch: one RLC program on the card
(K1-K4), inline (pipeline_depth 1) or on the blocksync lane of a
VerifyPipeline (depth 2 and more); a rejected window is localized by
the per-signature program (K1 + K14).  Each verified block is then
validated, stored and applied through the BlockExecutor.  On catch-up
it hands off to the consensus reactor (SwitchToConsensus), when it has
one.

`BlocksyncReactor(device=)` (default "cuda") is the device of every
verify and of the pipeline, and must be the executor's; without a card
it raises unless given device="cpu".

Only a block that fails validation (PEER_FAULTS) is blamed on the peers
that served it.  Any other exception, such as a kernel that does not
build (ops/_build.KernelBuildError) or a device fault, blames no peer:
it stops the sync, stays in `.error`, and `wait_synced` raises it.
"""

from __future__ import annotations

import os
import threading
import time

from ..crypto import sigcache
from ..libs import tracetl
from ..libs.trace import span as trace_span
from ..ops import device as devmod
from ..p2p.base_reactor import Envelope, Reactor
from ..p2p.conn.connection import ChannelDescriptor
from ..state.validation import InvalidBlockError
from ..types import validation
from ..types.block import BlockID, ExtendedCommit
from ..types.part_set import PartSet, PartSetError
from . import messages as bm
from .pool import BlockPool

BLOCKSYNC_CHANNEL = 0x40
TRY_SYNC_INTERVAL = 0.01
# blocks whose LastCommit signatures batch into one device dispatch:
# the JAX package's window (its depth sweep rewarded 48).  The pool
# keeps MAX_PENDING_REQUESTS=64 blocks in flight so a full window can
# fill.
VERIFY_WINDOW = 48
STATUS_UPDATE_INTERVAL = 10.0
SWITCH_TO_CONSENSUS_INTERVAL = 1.0
# overlapped verify pipeline depth (crypto/dispatch.py): collect+pack
# window N+1 while window N is on the card and window N-1 applies and
# stores.  1 = the serial path; 2 = double buffering (the default)
PIPELINE_DEPTH = 2
# mesh round-robin for the verify pipeline: windows rotate over this
# many cards (ops/sharding.mesh_device_list semantics; 0 = no mesh
# unless COMETBFT_TPU_MESH_DEVICES asks for one)
MESH_DEVICES = 0
# QoS lane override for blocksync verify windows (crypto/sched.py):
# empty = schedule under the blocksync lane itself.  An operator
# catching a node up BEFORE it may join consensus can re-lane the sync
# traffic urgent (e.g. "light" or "evidence" class) — attribution
# (trace/ledger/cache) stays blocksync either way.
SCHED_LANE = os.environ.get(
    "COMETBFT_TPU_SCHED_BLOCKSYNC_LANE", "") or None
# what a served block can be blamed for: a LastCommit that does not
# verify, a block that does not validate, a malformed part set or
# structure.  The window's verdict itself blames only a
# CommitVerificationError.
PEER_FAULTS = (validation.CommitVerificationError, InvalidBlockError,
               PartSetError, ValueError)


class BlocksyncReactor(Reactor):
    def __init__(self, state, block_exec, block_store, block_sync: bool,
                 consensus_reactor=None, peer_timeout: float | None = None,
                 device="cuda", pipeline_depth: int = PIPELINE_DEPTH):
        super().__init__("BlocksyncReactor")
        self.device = devmod.resolve(device)
        if block_exec.device != self.device:
            raise ValueError(
                f"the executor runs on {block_exec.device}, the reactor "
                f"on {self.device}")
        self.initial_state = state
        self.state = state
        self.block_exec = block_exec
        self.store = block_store
        self.block_sync = block_sync       # actively syncing?
        self.consensus_reactor = consensus_reactor
        self.peer_timeout = peer_timeout   # None -> pool.PEER_TIMEOUT
        self.pool = BlockPool(
            max(self.store.height() + 1, state.initial_height),
            self._send_block_request, self._on_peer_error,
            peer_timeout=peer_timeout)
        self._stop_sync = threading.Event()
        self.synced = not block_sync
        self.error = None          # what stopped the sync, not a peer
        self._finished = threading.Event()
        self.timeline = None       # per-node event timeline (tracetl)
        self.pipeline_depth = pipeline_depth
        self._pipeline = None      # crypto/dispatch.VerifyPipeline

    def get_channels(self) -> list:
        return [ChannelDescriptor(
            BLOCKSYNC_CHANNEL, priority=5,
            send_queue_capacity=1000,
            recv_message_capacity=150 * 1024 * 1024)]

    def on_start(self) -> None:
        if self.block_sync:
            self.pool.start()
            threading.Thread(target=self._pool_routine,
                             name="blocksync-pool", daemon=True).start()

    def on_stop(self) -> None:
        self._stop_sync.set()
        self.pool.stop()
        if self._pipeline is not None:
            self._pipeline.stop()
            self._pipeline = None

    def _get_pipeline(self):
        # return the LOCAL reference: on_stop may null self._pipeline
        # concurrently, and re-reading the attribute here handed the
        # pool routine a None mid-shutdown
        pipe = self._pipeline
        if pipe is None or not pipe.is_running():
            from ..crypto.dispatch import VerifyPipeline
            from ..ops import sharding
            devices = sharding.mesh_device_list(MESH_DEVICES or None)
            depth = self.pipeline_depth if devices is None else \
                max(self.pipeline_depth, 2 * len(devices))
            pipe = VerifyPipeline(
                depth=depth, name="blocksync-pipeline",
                devices=devices if devices is not None else (),
                device=self.device)
            pipe.start()
            self._pipeline = pipe
        return pipe

    # -- peer lifecycle ----------------------------------------------------
    def add_peer(self, peer) -> None:
        peer.try_send(BLOCKSYNC_CHANNEL, bm.wrap(bm.StatusResponse(
            height=self.store.height(), base=self.store.base())))

    def remove_peer(self, peer, reason) -> None:
        self.pool.remove_peer(peer.id)

    # -- plumbing for the pool --------------------------------------------
    def _send_block_request(self, height: int, peer_id: str) -> None:
        peer = self.switch.peers.get(peer_id) if self.switch else None
        if peer is None:
            raise RuntimeError(f"peer {peer_id} gone")
        if not peer.try_send(BLOCKSYNC_CHANNEL,
                             bm.wrap(bm.BlockRequest(height))):
            raise RuntimeError(f"peer {peer_id} send queue full")

    def _on_peer_error(self, peer_id: str, reason: str) -> None:
        if self.switch is None:
            return
        peer = self.switch.peers.get(peer_id)
        if peer is not None:
            self.switch.stop_peer_for_error(peer, reason)

    # -- receive -----------------------------------------------------------
    def receive(self, envelope: Envelope) -> None:
        with trace_span("blocksync", "decode"), \
                tracetl.span_for(self, "blocksync", "decode"):
            msg = bm.unwrap(bytes(envelope.message))
        if envelope.tctx is not None:
            tl = tracetl.active(self)
            if tl is not None:
                tl.recv("blocksync", type(msg).__name__, envelope.tctx)
        peer = envelope.src
        if isinstance(msg, bm.BlockRequest):
            self._respond_to_block_request(peer, msg.height)
        elif isinstance(msg, bm.StatusRequest):
            peer.try_send(BLOCKSYNC_CHANNEL, bm.wrap(bm.StatusResponse(
                height=self.store.height(), base=self.store.base())))
        elif isinstance(msg, bm.BlockResponse):
            if msg.block is not None:
                self.pool.add_block(peer.id, msg.block, msg.ext_commit)
        elif isinstance(msg, bm.StatusResponse):
            self.pool.set_peer_range(peer.id, msg.base, msg.height)
        elif isinstance(msg, bm.NoBlockResponse):
            self.pool.no_block_response(peer.id, msg.height)

    def _respond_to_block_request(self, peer, height: int) -> None:
        # serve the serialized block directly: on a warm cache
        # (store.load_block_bytes) this is a bytes splice — no block
        # decode, no re-encode, no part split
        block_bytes = self.store.load_block_bytes(height)
        if block_bytes is None:
            peer.try_send(BLOCKSYNC_CHANNEL,
                          bm.wrap(bm.NoBlockResponse(height)))
            return
        ext = None
        raw_ext = self.store.load_extended_commit(height)
        if raw_ext is not None:
            ext = ExtendedCommit.from_proto(raw_ext) \
                if isinstance(raw_ext, (bytes, bytearray)) else raw_ext
        tctx = None
        tl = tracetl.active(self)
        if tl is not None:
            # causal edge: the requester's recv ties its apply work to
            # this serve (round 0 — blocksync is height-only)
            tctx = tl.ctx(height, 0)
            tl.send("blocksync", "BlockResponse", tctx)
        peer.try_send(BLOCKSYNC_CHANNEL,
                      bm.wrap_block_response_bytes(block_bytes, ext),
                      tctx=tctx)

    # -- sync driver -------------------------------------------------------
    def wait_synced(self, timeout: float | None = None) -> bool:
        """Wait until the sync ends: True once the node has caught up,
        False if it was stopped first or `timeout` passed.  Raises the
        exception that stopped it, when one did (`.error`)."""
        self._finished.wait(timeout)
        if self.error is not None:
            raise self.error
        return self.synced

    def _pool_routine(self) -> None:
        """reactor.go:306 poolRoutine."""
        try:
            self._pool_loop()
        except Exception as e:
            # no peer's fault (those are handled where they arise):
            # stop syncing and keep the cause for wait_synced
            self.error = e
            self._stop_sync.set()
            self.pool.stop()
        finally:
            self._finished.set()

    def _pool_loop(self) -> None:
        last_status = 0.0
        last_switch_check = 0.0
        while not self._stop_sync.is_set() and self.is_running():
            now = time.monotonic()
            if now - last_status > STATUS_UPDATE_INTERVAL:
                last_status = now
                if self.switch is not None:
                    self.switch.try_broadcast(
                        BLOCKSYNC_CHANNEL, bm.wrap(bm.StatusRequest()))
            if now - last_switch_check > SWITCH_TO_CONSENSUS_INTERVAL:
                last_switch_check = now
                if self._maybe_switch_to_consensus():
                    return
            if not self._try_sync_one():
                time.sleep(TRY_SYNC_INTERVAL)

    def _try_sync_one(self) -> bool:
        """reactor.go:534 processBlock, WINDOWED: all the LastCommit
        signature checks for a run of downloaded blocks batch into ONE
        device dispatch (types.DeferredSigBatch — the BASELINE
        'blocksync replay' configuration), then blocks apply one by
        one.  Batching beyond the next height is gated on the headers
        carrying the CURRENT next_validators hash; a lying header
        cannot commit anything — apply-time validate_block re-checks
        the executed validator set before each block lands.

        With pipeline_depth >= 2 the overlapped path runs instead:
        window N+1 collects and host-packs while window N's dispatch
        is in flight on device and window N-1 applies/stores
        (_sync_pipelined); depth 1 keeps the strictly serial loop."""
        if self.pipeline_depth >= 2:
            return self._sync_pipelined()
        return self._sync_serial()

    def _sync_serial(self) -> bool:
        window, after = self.pool.peek_window(VERIFY_WINDOW)
        usable = len(window) if after is not None else len(window) - 1
        if usable < 1:
            return False
        # a missing extended commit makes its block unusable — gate the
        # window BEFORE burning a device dispatch (reactor.go:540)
        for i in range(usable):
            block, ext = window[i]
            if ext is None and self.state.consensus_params \
                    .vote_extensions_enabled(block.header.height):
                if i == 0:
                    for pid in self.pool.redo_request(
                            block.header.height):
                        self._on_peer_error(pid,
                                            "missing extended commit")
                    return False
                usable = i
                break
        # quantize to a power of two so the device sees few distinct
        # batch shapes (each new shape is a one-off compile)
        while usable & (usable - 1):
            usable &= usable - 1
        blocks = [b for b, _ in window]
        commits = []
        for i in range(usable):
            nxt = blocks[i + 1] if i + 1 < len(window) else after
            commits.append(nxt.last_commit)

        # valset per window offset: exact for +0/+1; further only while
        # headers pin the unchanged next_validators hash
        next_hash = self.state.next_validators.hash(device=self.device) \
            if self.state.next_validators else None
        batch = validation.DeferredSigBatch()
        verified = 0
        parts_ids = []
        collecting_h = blocks[0].header.height
        try:
            with trace_span("blocksync", "verify_dispatch"):
                for i in range(usable):
                    block = blocks[i]
                    collecting_h = block.header.height
                    if i == 0:
                        vals = self.state.validators
                    elif block.header.validators_hash == next_hash:
                        vals = self.state.next_validators
                    else:
                        break
                    parts = PartSet.from_data(block.to_proto())
                    bid = BlockID(block.hash(), parts.header)
                    parts_ids.append((parts, bid))
                    vals.verify_commit_light(
                        self.state.chain_id, bid, block.header.height,
                        commits[i], defer_to=batch, device=self.device)
                    verified += 1
        except PEER_FAULTS:
            # structural errors (bad commit shape, not enough power)
            # fail while collecting the height to blame
            self._blame(collecting_h)
            return False
        try:
            # HOT PATH: one device dispatch for the whole window.
            # Verdicts land in the process-wide sigcache, so the
            # apply-time validate_block below (and the NEXT height's
            # LastCommit check at +1) re-verify for free.
            with trace_span("blocksync", "device"), \
                    sigcache.consumer("blocksync"):
                batch.verify(device=self.device)
        except validation.CommitVerificationError as e:
            # a deferred signature failure carries its height as
            # failed_ctx
            self._blame(getattr(e, "failed_ctx", None)
                        or blocks[0].header.height)
            return False

        progressed, _, _ = self._apply_window(blocks, window, parts_ids,
                                              commits, verified)
        return progressed

    def _apply_window(self, blocks, window, parts_ids, commits,
                      verified) -> tuple[bool, int, bool]:
        """Apply + store `verified` signature-verified blocks one by
        one (the serial tail of reactor.go:534 processBlock).  Returns
        (progressed, popped, clean): popped counts blocks actually
        landed; clean is False when a refetch/eviction interrupted the
        window — the pipelined path then drops its lookahead (those
        heights re-peek after the pool recovers)."""
        progressed = False
        popped = 0
        for i in range(verified):
            first = blocks[i]
            first_ext = window[i][1]
            ext_enabled = self.state.consensus_params \
                .vote_extensions_enabled(first.header.height)
            if ext_enabled and first_ext is None:
                # params changed mid-window (a block we just applied
                # enabled extensions): the pre-gate used the old
                # params — refetch, don't evict (reactor.go:540)
                for pid in self.pool.redo_request(first.header.height):
                    self._on_peer_error(pid, "missing extended commit")
                return progressed, popped, False
            parts, first_id = parts_ids[i]
            try:
                with trace_span("blocksync", "apply"), \
                        tracetl.span_for(self, "blocksync", "apply",
                                         height=first.header.height):
                    if ext_enabled:
                        first_ext.ensure_extensions(True)
                    # all-hits when the window's device dispatch (or a
                    # live consensus round) already resolved these
                    # LastCommit triples into the verdict cache
                    with sigcache.consumer("blocksync"):
                        self.block_exec.validate_block(self.state, first)
            except PEER_FAULTS:
                # evict BOTH suppliers (reactor.go:560): the next
                # block's LastCommit drove the batched verify
                self._blame(first.header.height)
                return progressed, popped, False
            self.pool.pop_request()
            popped += 1
            with trace_span("blocksync", "store"), \
                    tracetl.span_for(self, "blocksync", "store",
                                     height=first.header.height):
                if ext_enabled:
                    self.store.save_block(first, parts,
                                          first_ext.to_commit(),
                                          ext_commit=first_ext.to_proto())
                else:
                    self.store.save_block(first, parts, commits[i])
            with trace_span("blocksync", "apply"), \
                    tracetl.span_for(self, "blocksync", "apply",
                                     height=first.header.height):
                self.state = self.block_exec.apply_verified_block(
                    self.state, first_id, first,
                    syncing_to_height=self.pool.max_peer_height())
            progressed = True
        return progressed, popped, True

    def _blame(self, height: int) -> None:
        for pid in self.pool.redo_request(height):
            self._on_peer_error(pid, "served invalid block")

    # -- overlapped pipeline ----------------------------------------------

    def _collect_ahead(self, offset: int):
        """Collect ONE verify window starting `offset` blocks past
        pool.height (the lookahead over in-flight windows): the same
        structure checks, power tallies, sign-bytes templating, and
        partset chunking as the serial path, with signature checks
        deferred into a DeferredSigBatch for the pipeline.

        Lookahead windows (offset > 0) are collected BEFORE earlier
        windows apply, so every one of their blocks must pin the
        CURRENT next_validators hash — the same trust discipline the
        serial path uses past height+1; apply-time validate_block
        re-checks the executed validator set before anything lands.
        Returns None when nothing (more) is collectable; peer blame
        for structural failures only fires at offset 0, where the
        state is current (a lookahead failure re-collects as the head
        window next pass and blames then)."""
        window, after = self.pool.peek_window(VERIFY_WINDOW, offset)
        usable = len(window) if after is not None else len(window) - 1
        if usable < 1:
            return None
        for i in range(usable):
            block, ext = window[i]
            if ext is None and self.state.consensus_params \
                    .vote_extensions_enabled(block.header.height):
                if i == 0:
                    if offset == 0:
                        for pid in self.pool.redo_request(
                                block.header.height):
                            self._on_peer_error(
                                pid, "missing extended commit")
                    return None
                usable = i
                break
        while usable & (usable - 1):
            usable &= usable - 1
        blocks = [b for b, _ in window]
        commits = []
        for i in range(usable):
            nxt = blocks[i + 1] if i + 1 < len(window) else after
            commits.append(nxt.last_commit)

        next_hash = self.state.next_validators.hash(device=self.device) \
            if self.state.next_validators else None
        batch = validation.DeferredSigBatch()
        verified = 0
        parts_ids = []
        collecting_h = blocks[0].header.height
        try:
            with trace_span("blocksync", "verify_dispatch",
                            offset=offset), \
                    trace_span("blocksync", "collect", offset=offset), \
                    tracetl.span_for(self, "blocksync", "collect",
                                     offset=offset):
                for i in range(usable):
                    block = blocks[i]
                    collecting_h = block.header.height
                    if offset == 0 and i == 0:
                        vals = self.state.validators
                    elif block.header.validators_hash == next_hash:
                        vals = self.state.next_validators
                    else:
                        break
                    parts = PartSet.from_data(block.to_proto())
                    bid = BlockID(block.hash(), parts.header)
                    parts_ids.append((parts, bid))
                    vals.verify_commit_light(
                        self.state.chain_id, bid, block.header.height,
                        commits[i], defer_to=batch, device=self.device)
                    verified += 1
        except PEER_FAULTS:
            if offset == 0:
                self._blame(collecting_h)
            return None
        if verified < 1:
            return None
        return {"blocks": blocks, "window": window,
                "parts_ids": parts_ids, "commits": commits,
                "verified": verified, "batch": batch}

    def _sync_pipelined(self) -> bool:
        """The overlapped ingest loop: up to pipeline_depth windows in
        flight at once — window N+1 collects/packs (host threads)
        while window N's RLC dispatch runs on device and window N-1
        applies/stores.  Verdicts resolve strictly in submission
        order, and NO block applies before its window's verdict future
        resolved true; a reject abandons the lookahead (blocks stay in
        the pool — no loss) and the next pass retries through the
        normal blame path.  (The pipeline itself sends a window to the
        host after a device fault; what it raises instead, such as a
        KernelBuildError, stops the sync.)"""
        pipe = self._get_pipeline()
        inflight: list[dict] = []
        offset = 0
        progressed = False
        # yield back to the pool routine periodically so its status
        # broadcasts and switch-to-consensus checks keep their cadence;
        # past the deadline the fill stops and in-flight drains
        deadline = time.monotonic() + SWITCH_TO_CONSENSUS_INTERVAL
        # pipe.depth >= pipeline_depth: a mesh pipeline raises its
        # depth to keep every device's rotation slot fed
        fill_depth = max(self.pipeline_depth, pipe.depth)
        while True:
            while len(inflight) < fill_depth \
                    and not self._stop_sync.is_set() \
                    and time.monotonic() < deadline:
                rec = self._collect_ahead(offset)
                if rec is None:
                    break
                rec["verdict"] = rec.pop("batch").verify_async(
                    pipe, subsystem="blocksync", lane=SCHED_LANE)
                inflight.append(rec)
                offset += rec["verified"]
            if not inflight:
                return progressed
            rec = inflight.pop(0)
            try:
                # HOT PATH: the window's single device dispatch —
                # later windows are collecting/packing RIGHT NOW
                with trace_span("blocksync", "device_wait",
                                inflight=len(inflight) + 1), \
                        tracetl.span_for(self, "blocksync",
                                         "device_wait"):
                    rec["verdict"].wait()
            except validation.CommitVerificationError as e:
                # abandoned lookahead windows resolve in the
                # background; their blocks were never popped from the
                # pool, so nothing is lost — the next pass re-peeks
                self._blame(getattr(e, "failed_ctx", None)
                            or rec["blocks"][0].header.height)
                return progressed
            applied, popped, clean = self._apply_window(
                rec["blocks"], rec["window"], rec["parts_ids"],
                rec["commits"], rec["verified"])
            progressed = progressed or applied
            offset -= rec["verified"]
            if not clean or popped != rec["verified"]:
                return progressed
            if self._stop_sync.is_set() or not self.is_running():
                return progressed

    def _maybe_switch_to_consensus(self) -> bool:
        """reactor.go:520: hand off when caught up."""
        if self.pool.is_caught_up():
            self.block_sync = False
            self.synced = True
            self._stop_sync.set()
            self.pool.stop()
            if self.consensus_reactor is not None:
                self.consensus_reactor.switch_to_consensus(self.state)
            return True
        return False
