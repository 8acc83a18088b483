"""Request coalescer (the port's copy of `cometbft_tpu.lightserve.
coalesce`): many concurrent sync requests, one verify per height.

Concurrent sync requests overlap heavily: every client walking to the
same tip shares the tail of its pivot chain, and popular trust heights
share whole paths.  The coalescer holds one shared future per in-flight
height: the first request to ask for a height enqueues it, every later
request attaches to the same future, and a flusher drains queued heights
into merged verify windows (the session's ``verify_fn``).

Fairness: queued heights are drained round-robin across requests, so a
one-height request rides the next flush beside a 60-height request's
head instead of behind its tail.

Locking: everything is guarded by one RankedCondition ("lightserve.cv",
ranked outside the stores and the verify plane); the lock is held only
around queue and counter changes, never across store reads or pipeline
submits.  ``verify_fn`` runs with no coalescer lock held.
"""

from __future__ import annotations

import inspect
import itertools
import threading
import time
from collections import OrderedDict, deque

from ..crypto import sigcache
from ..libs import latledger, lockrank
from ..libs import metrics as libmetrics

# the JAX package's defaults: the accumulation window before a flush and
# the most heights one merged window takes; pass other values to the
# constructor
DEFAULT_WINDOW_MS = 2.0
DEFAULT_MAX_BATCH = 512


class _Entry:
    __slots__ = ("future", "refs", "queued", "consumer")

    def __init__(self, future, consumer: str = "lightserve"):
        self.future = future
        self.refs = 1
        self.queued = True
        # the OLDEST claimant's consumer label: a merged flush
        # schedules under the most urgent claimant lane in the batch
        # (crypto/sched.py) while ledger/cache attribution stays the
        # session's own subsystem
        self.consumer = consumer


class RequestTicket:
    """One request's claim on its path heights: a mapping from height
    to the (possibly shared) verify future."""

    __slots__ = ("_co", "tid", "futures", "owned", "cancelled")

    def __init__(self, co, tid, futures, owned):
        self._co = co
        self.tid = tid
        self.futures = futures          # OrderedDict[height -> future]
        self.owned = owned              # heights this ticket enqueued
        self.cancelled = False

    def wait(self, timeout: float | None = None) -> None:
        """Block until every height verified; raises the first
        failure (in path order).  On failure the remaining resolved
        futures' exceptions are retrieved so nothing trips the
        future-leak sanitizer, and still-queued exclusive heights are
        released via cancel()."""
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            for fut in self.futures.values():
                left = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                fut.result(left)
        except BaseException:
            for fut in self.futures.values():
                if fut.done():
                    try:
                        fut.exception(timeout=0)
                    except BaseException:
                        pass
            self.cancel()
            raise

    def cancel(self) -> None:
        if not self.cancelled:
            self.cancelled = True
            self._co._cancel(self)


class RequestCoalescer:
    def __init__(self, verify_fn, *, window_ms: float | None = None,
                 max_batch: int | None = None, start: bool = True):
        # verify_fn(heights) -> dict[height -> Exception | None];
        # when it accepts a `lane` kwarg the flusher passes the most
        # urgent claimant lane of each merged batch (QoS scheduling
        # only — attribution is the session's)
        self._verify = verify_fn
        try:
            self._verify_takes_lane = "lane" in \
                inspect.signature(verify_fn).parameters
        except (TypeError, ValueError):   # builtins, odd callables
            self._verify_takes_lane = False
        self.window_s = (DEFAULT_WINDOW_MS if window_ms is None
                         else float(window_ms)) / 1000.0
        self.max_batch = max(1, DEFAULT_MAX_BATCH if max_batch is None
                             else int(max_batch))
        self._cv = lockrank.RankedCondition(name="lightserve.cv")
        self._entries: dict[int, _Entry] = {}
        # per-ticket pending queues + the round-robin rotation order
        self._queues: OrderedDict[int, deque] = OrderedDict()
        self._rr: deque = deque()
        self._ids = itertools.count(1)
        self._stop = False
        self._thread: threading.Thread | None = None
        self.flushes = 0
        self.coalesced = 0
        self.verified_heights = 0
        self.cancelled_heights = 0
        if start:
            self._thread = threading.Thread(
                target=self._run, name="lightserve-flush", daemon=True)
            self._thread.start()

    # -- request side ------------------------------------------------------

    def acquire(self, heights) -> RequestTicket:
        tid = next(self._ids)
        futures: OrderedDict = OrderedDict()
        owned: set[int] = set()
        attached = 0
        with self._cv:
            if self._stop:
                raise RuntimeError("coalescer is closed")
            q = None
            for h in heights:
                if h in futures:
                    continue        # duplicate within one request
                e = self._entries.get(h)
                if e is not None:
                    e.refs += 1
                    attached += 1
                    # every claimant on a shared height gets its OWN
                    # latency-ledger row: the attached request's wait
                    # is real even though the verify is shared (the
                    # owner's decomposition rides the merged pipeline
                    # window; this row lands as coalesce_wait)
                    req = latledger.submit(1, consumer="lightserve")
                    if req is not None:
                        e.future.add_done_callback(
                            lambda f, r=req: r.resolve_coalesced())
                else:
                    # record who FIRST asked for this height; the
                    # ambient default ("crypto" = nobody declared)
                    # means a plain serving request -> lightserve
                    label = sigcache.current_consumer()
                    e = _Entry(lockrank.TrackedFuture(),
                               consumer=label if label in sigcache.LANES
                               and label != "crypto" else "lightserve")
                    self._entries[h] = e
                    if q is None:
                        q = deque()
                        self._queues[tid] = q
                        self._rr.append(tid)
                    q.append(h)
                    owned.add(h)
                futures[h] = e.future
            self.coalesced += attached
            self._gauge_locked(attached)
            self._cv.notify_all()
        return RequestTicket(self, tid, futures, owned)

    def _cancel(self, ticket: RequestTicket) -> None:
        """Drop the ticket's claims: shared heights just lose a ref;
        exclusively-held heights still queued are removed entirely
        (their futures cancelled), so an abandoned request costs the
        flusher nothing."""
        with self._cv:
            q = self._queues.get(ticket.tid)
            for h, fut in ticket.futures.items():
                e = self._entries.get(h)
                if e is None or e.future is not fut:
                    continue
                e.refs -= 1
                if e.refs <= 0 and e.queued:
                    del self._entries[h]
                    self.cancelled_heights += 1
                    if q is not None:
                        try:
                            q.remove(h)
                        except ValueError:
                            pass
                    fut.cancel()
            if q is not None and not q:
                self._queues.pop(ticket.tid, None)
            self._gauge_locked(0)

    # -- flush side --------------------------------------------------------

    def _gauge_locked(self, attached: int) -> None:
        lm = libmetrics.lightserve_metrics()
        if lm is not None:
            if attached:
                lm.coalesced_heights_total.inc(attached)
            lm.inflight_heights.set(len(self._entries))

    def _drain_locked(self) -> list[int]:
        """Round-robin across ticket queues, one height per turn, up
        to max_batch."""
        batch: list[int] = []
        spins = len(self._rr)
        while self._rr and len(batch) < self.max_batch and spins >= 0:
            tid = self._rr.popleft()
            q = self._queues.get(tid)
            if not q:
                self._queues.pop(tid, None)
                spins -= 1
                continue
            h = q.popleft()
            if q:
                self._rr.append(tid)
            else:
                self._queues.pop(tid, None)
            e = self._entries.get(h)
            if e is not None and e.queued:
                e.queued = False
                batch.append(h)
        return batch

    def _flush_once(self) -> int:
        """Drain one merged batch and verify it; resolves the heights'
        shared futures.  Returns the batch size (0 = nothing queued)."""
        with self._cv:
            batch = self._drain_locked()
            lanes = [self._entries[h].consumer for h in batch
                     if h in self._entries]
        if not batch:
            return 0
        try:
            if self._verify_takes_lane:
                # the merged window rides the MOST URGENT claimant's
                # lane: one consensus-priority claimant lifts the
                # whole shared flush
                lane = (min(lanes, key=sigcache.lane_priority)
                        if lanes else None)
                results = self._verify(batch, lane=lane)
            else:
                results = self._verify(batch)
        except Exception as exc:        # verify_fn itself failed
            results = {h: exc for h in batch}
        with self._cv:
            self.flushes += 1
            self.verified_heights += len(batch)
            resolved = [(h, self._entries.pop(h, None)) for h in batch]
            self._gauge_locked(0)
        for h, e in resolved:
            if e is None:
                continue
            exc = results.get(h)
            if exc is None:
                e.future.set_result(True)
            else:
                e.future.set_exception(exc)
                if e.refs <= 0:
                    # every claimant cancelled while the flush was in
                    # flight: retrieve the exception ourselves so the
                    # dropped future is not a sanitizer leak
                    try:
                        e.future.exception(timeout=0)
                    except BaseException:
                        pass
        return len(batch)

    def flush_now(self) -> int:
        """Synchronously drain everything queued (tests, close)."""
        total = 0
        while True:
            n = self._flush_once()
            if n == 0:
                return total
            total += n

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._stop and not self._queues:
                    self._cv.wait(timeout=0.1)
                if self._stop:
                    return
            # accumulation window: let concurrent arrivals merge into
            # this flush before draining
            if self.window_s > 0:
                time.sleep(self.window_s)
            self._flush_once()

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)
        # serve whatever was still queued so no future hangs forever
        self.flush_now()

    def stats(self) -> dict:
        with self._cv:
            return {
                "flushes": self.flushes,
                "coalesced": self.coalesced,
                "verified_heights": self.verified_heights,
                "cancelled_heights": self.cancelled_heights,
                "inflight_heights": len(self._entries),
                "pending_tickets": len(self._queues),
            }
