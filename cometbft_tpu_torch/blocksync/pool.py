"""BlockPool: schedules block downloads across peers (the port's copy of
`cometbft_tpu.blocksync.pool`; CometBFT internal/blocksync/pool.go).

Keeps a sliding window of in-flight height requests, each owned by a
requester; blocks are surfaced to the reactor IN ORDER via peek_window
(each block is verified with the following block's LastCommit before
being applied).
"""

from __future__ import annotations

import random
import threading
import time

from ..libs import lockrank
from ..libs.service import BaseService

REQUEST_INTERVAL = 0.01          # pool.go requestInterval (10ms)
MAX_PENDING_REQUESTS = 64        # window size: >= the 48-block
                                 # verify window the r4b depth sweep
                                 # rewards (reactor.VERIFY_WINDOW)
MAX_PENDING_REQUESTS_PER_PEER = 20
PEER_TIMEOUT = 15.0              # pool.go peerTimeout
# retry jitter bound for refetches (_redo_request): N peers that all
# timed out on the same stalled height otherwise re-request in
# lockstep, hammering whichever peer the random choice converges on
RETRY_JITTER = 0.05


class _Peer:
    def __init__(self, peer_id: str, base: int, height: int):
        self.id = peer_id
        self.base = base
        self.height = height
        self.num_pending = 0
        self.timeout_at: float | None = None

    def arm_timeout(self, timeout: float | None = None) -> None:
        if self.timeout_at is None:
            self.timeout_at = time.monotonic() + (
                timeout if timeout is not None else PEER_TIMEOUT)

    def reset_timeout(self, timeout: float | None = None) -> None:
        """On every delivered block: an actively responsive peer must
        not expire mid-sync (pool.go decrPending)."""
        if self.num_pending > 0:
            self.timeout_at = time.monotonic() + (
                timeout if timeout is not None else PEER_TIMEOUT)
        else:
            self.timeout_at = None

    def disarm_if_idle(self) -> None:
        if self.num_pending == 0:
            self.timeout_at = None


class _Requester:
    """One in-flight height (pool.go bpRequester)."""

    def __init__(self, height: int):
        self.height = height
        self.peer_id: str | None = None
        self.block = None
        self.ext_commit = None
        self.excluded: set[str] = set()  # peers that failed this height
        self.not_before = 0.0            # jittered refetch hold-off


class BlockPool(BaseService):
    def __init__(self, start_height: int, send_request,
                 on_peer_error=None, peer_timeout: float | None = None,
                 retry_jitter: float | None = None):
        """send_request(height, peer_id) issues a BlockRequest;
        on_peer_error(peer_id, reason) reports misbehaving peers.
        peer_timeout/retry_jitter of None defer to the module knobs
        (PEER_TIMEOUT / RETRY_JITTER) at use time, the late binding
        the simnet tuner and tests monkeypatch."""
        super().__init__("BlockPool")
        self._mtx = lockrank.RankedRLock("blocksync.pool")
        self.start_height = start_height
        self.height = start_height       # next height to sync
        self.peer_timeout = peer_timeout
        self.retry_jitter = retry_jitter
        self._peers: dict[str, _Peer] = {}
        self._requesters: dict[int, _Requester] = {}
        self._send_request = send_request
        self._on_peer_error = on_peer_error or (lambda pid, r: None)
        self.last_advance = time.monotonic()
        self._thread: threading.Thread | None = None

    def _peer_timeout(self) -> float:
        return self.peer_timeout if self.peer_timeout is not None \
            else PEER_TIMEOUT

    def _retry_jitter(self) -> float:
        return self.retry_jitter if self.retry_jitter is not None \
            else RETRY_JITTER

    # -- lifecycle ---------------------------------------------------------
    def on_start(self) -> None:
        self._thread = threading.Thread(target=self._make_requesters_routine,
                                        name="blockpool", daemon=True)
        self._thread.start()

    def on_stop(self) -> None:
        pass

    def _make_requesters_routine(self) -> None:
        """pool.go:116: keep the request window full; unassigned or
        failed requesters are re-assigned on every pass (no recursion,
        no permanent orphans)."""
        while self.is_running():
            with self._mtx:
                pending = len(self._requesters)
                max_height = self._max_peer_height()
                next_height = self.height + pending
                if pending < MAX_PENDING_REQUESTS and \
                        next_height <= max_height and \
                        next_height not in self._requesters:
                    self._requesters[next_height] = _Requester(
                        next_height)
                # all unassigned requesters past their jittered
                # hold-off are assignment candidates
                now = time.monotonic()
                todo = [r for r in self._requesters.values()
                        if r.peer_id is None and r.block is None
                        and r.not_before <= now]
            progressed = False
            for req in todo:
                if self._assign_and_send(req):
                    progressed = True
                elif req.excluded and self._peers and \
                        all(p in req.excluded for p in self._peers):
                    # every live peer failed this height: forgive so the
                    # request can cycle rather than wedge
                    req.excluded.clear()
            if not progressed:
                time.sleep(REQUEST_INTERVAL)
            self._check_timeouts()

    def _assign_and_send(self, req: _Requester) -> bool:
        """Try once; on failure leave the requester unassigned for the
        next routine pass. Returns True if a request went out."""
        with self._mtx:
            candidates = [
                p for p in self._peers.values()
                if p.id not in req.excluded
                and p.base <= req.height <= p.height
                and p.num_pending < MAX_PENDING_REQUESTS_PER_PEER]
            if not candidates:
                return False
            peer = random.choice(candidates)
            req.peer_id = peer.id
            peer.num_pending += 1
            peer.arm_timeout(self._peer_timeout())
        try:
            self._send_request(req.height, peer.id)
            return True
        except Exception:
            with self._mtx:
                req.peer_id = None
                req.excluded.add(peer.id)
                live = self._peers.get(peer.id)
                if live is not None:
                    live.num_pending -= 1
                    live.disarm_if_idle()
            return False

    def _check_timeouts(self) -> None:
        now = time.monotonic()
        with self._mtx:
            expired = [p for p in self._peers.values()
                       if p.timeout_at is not None and now > p.timeout_at]
        for p in expired:
            self.remove_peer(p.id)
            self._on_peer_error(p.id, "blocksync request timeout")

    # -- peer management ---------------------------------------------------
    def set_peer_range(self, peer_id: str, base: int,
                       height: int) -> None:
        """From a StatusResponse (pool.go SetPeerRange)."""
        with self._mtx:
            p = self._peers.get(peer_id)
            if p is None:
                self._peers[peer_id] = _Peer(peer_id, base, height)
            else:
                p.base = base
                p.height = max(p.height, height)

    def remove_peer(self, peer_id: str) -> None:
        with self._mtx:
            self._peers.pop(peer_id, None)
            # its in-flight requests go back to the unassigned state;
            # the requesters routine re-assigns them
            for r in self._requesters.values():
                if r.peer_id == peer_id and r.block is None:
                    r.peer_id = None
                    r.excluded.add(peer_id)

    def _redo_request(self, height: int, exclude_peer: str) -> None:
        """Unassign so the requesters routine refetches from another
        peer (never recursive)."""
        with self._mtx:
            req = self._requesters.get(height)
            if req is None:
                return
            if req.peer_id is not None:
                p = self._peers.get(req.peer_id)
                # only an in-flight request still counts against the
                # peer; a delivered block was decremented in add_block
                if p is not None and req.block is None:
                    p.num_pending -= 1
                    p.disarm_if_idle()
            if exclude_peer:
                req.excluded.add(exclude_peer)
            req.peer_id = None
            req.block = None
            req.ext_commit = None
            # jitter the refetch so simultaneous timeouts across many
            # heights do not re-request (and re-time-out) in lockstep
            jitter = self._retry_jitter()
            if jitter > 0:
                req.not_before = time.monotonic() + \
                    random.uniform(0, jitter)

    def _max_peer_height(self) -> int:
        with self._mtx:
            return max((p.height for p in self._peers.values()),
                       default=0)

    def max_peer_height(self) -> int:
        return self._max_peer_height()

    # -- block intake ------------------------------------------------------
    def add_block(self, peer_id: str, block, ext_commit) -> None:
        """pool.go AddBlock."""
        height = block.header.height
        with self._mtx:
            req = self._requesters.get(height)
            if req is None or req.peer_id != peer_id:
                # unsolicited block: punish (pool.go:297)
                self._on_peer_error(
                    peer_id, f"unsolicited block at height {height}")
                return
            if req.block is not None:
                return  # duplicate response: ignore (requester.setBlock)
            req.block = block
            req.ext_commit = ext_commit
            p = self._peers.get(peer_id)
            if p is not None:
                p.num_pending -= 1
                p.reset_timeout(self._peer_timeout())

    def no_block_response(self, peer_id: str, height: int) -> None:
        self._redo_request(height, peer_id)

    # -- consumer ----------------------------------------------------------
    def peek_window(self, max_blocks: int, offset: int = 0):
        """Consecutive downloaded blocks from self.height + offset: a
        list of (block, ext_commit) of length <= max_blocks, plus the
        block at the following height if present (its LastCommit
        verifies the last window entry).  The windowed verify path
        batches all the commits into one device dispatch
        (types.DeferredSigBatch); the overlapped pipeline peeks AHEAD
        of in-flight windows via `offset` so window N+1 collects while
        window N is on device."""
        with self._mtx:
            window = []
            h = self.height + offset
            while len(window) < max_blocks:
                r = self._requesters.get(h)
                if r is None or r.block is None:
                    break
                window.append((r.block, r.ext_commit))
                h += 1
            nxt = self._requesters.get(h)
            return window, (nxt.block if nxt else None)

    def pop_request(self) -> None:
        """The block at self.height was applied (pool.go PopRequest)."""
        with self._mtx:
            self._requesters.pop(self.height, None)
            self.height += 1
            self.last_advance = time.monotonic()

    def redo_request(self, height: int) -> list[str]:
        """First block failed verification: the peers that supplied BOTH
        blocks are suspect (the second's LastCommit drove the failed
        verify) — remove them and refetch (reactor.go:560-575).
        Returns the offending peer ids."""
        bad: list[str] = []
        with self._mtx:
            for h in (height, height + 1):
                req = self._requesters.get(h)
                if req is not None and req.peer_id:
                    bad.append(req.peer_id)
        for pid in bad:
            self.remove_peer(pid)
        for h in (height, height + 1):
            with self._mtx:
                r = self._requesters.get(h)
            if r is not None:
                for pid in bad:
                    self._redo_request(h, pid)
        return bad

    def is_caught_up(self) -> bool:
        """pool.go IsCaughtUp: within one block of the best peer."""
        with self._mtx:
            if not self._peers:
                return False
            return self.height >= max(
                p.height for p in self._peers.values())
