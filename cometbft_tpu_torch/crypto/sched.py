"""Deadline-aware QoS scheduler for the verify pipeline: the port's
copy of `cometbft_tpu.crypto.sched`.

Windows live in ``VerifyPipeline._windows`` in submission order; the
scheduler is pure selection logic over that list: which unstaged window
to stage next, which staged window a free device takes, and whether a
device should briefly hold idle for a more urgent window still staging.

- **Scan-based, no shadow queues.**  Every decision scans the
  pipeline's ``_windows`` under the pipeline's condition variable: no
  second structure to fall out of step with the watchdog, drain and
  brownout paths, and no lock of its own.
- **Lanes are consumer labels.**  ``sigcache.LANES`` maps each
  registered consumer label to a priority class (lower = more urgent);
  labels outside it share one ``default`` lane, FIFO among themselves.
- **Deadline promotion guards against starvation.**  A window whose
  queue age exceeds its lane's declared p99 target
  (``latledger.target_for``) is promoted ahead of every normal class,
  FIFO among promoted peers.
- **Deficit round-robin inside a priority class.**  Lanes of one class
  split device time by signature count, not window count.
- **Disabled == FIFO.**  With ``enabled=False`` every window is in one
  lane at one priority, and every selection is the head-of-queue scan.

The clock is injectable.  Accounting happens under the pipeline cv
(``note_dispatch``); the event (metrics counters, the flight recorder's
``EV_SCHED_PREEMPT``) is returned as a dict for ``emit`` after the cv
is released.
"""

from __future__ import annotations

import time

from ..libs import flightrec
from ..libs import latledger
from ..libs import metrics as libmetrics
from . import sigcache

# Deficit round-robin quantum, in signatures, credited to a same-class
# lane each time it is passed over.  Larger values trade fairness
# granularity for fewer rotation steps.
DEFAULT_QUANTUM = 256

# Longest a free device will sit idle (cause `sched_hold`) waiting for a
# strictly-higher-priority window that is actively staging, instead of
# taking lower-priority staged work.  0 disables holding entirely.
DEFAULT_HOLD_S = 0.002

# Effective priority of a deadline-promoted window: ahead of every
# normal class (sigcache lane classes start at 0).
_PROMOTED = -1

# Lane identity for labels outside the sigcache registry.  All untagged
# traffic shares this lane, preserving global FIFO among itself.
DEFAULT_LANE = "default"


class _LaneStats:
    __slots__ = ("windows", "sigs", "preemptions", "held_s")

    def __init__(self) -> None:
        self.windows = 0
        self.sigs = 0
        self.preemptions = 0
        self.held_s = 0.0


class QosScheduler:
    """Selection policy over the pipeline's window list.

    Every method that takes ``windows`` must be called with the
    pipeline's condition variable held; ``emit`` must be called with it
    released.  The clock is injectable so the ordering, promotion, and
    hold policies are testable with a fake clock.
    """

    def __init__(self, *, enabled: bool = True,
                 quantum: int | None = None,
                 hold_s: float | None = None,
                 clock=time.monotonic):
        self.enabled = enabled
        self.quantum = DEFAULT_QUANTUM if quantum is None else int(quantum)
        if self.quantum <= 0:
            self.quantum = 1
        self.hold_s = DEFAULT_HOLD_S if hold_s is None else float(hold_s)
        self._clock = clock
        self._seq = 0
        # DRR state for equal-priority lanes: label -> deficit in sigs,
        # plus a rotation cursor over the sorted label list.
        self._deficit: dict[str, float] = {}
        self._rr_idx = 0
        # device key -> monotonic time the hold started (a device only
        # appears here while it is deliberately idling for a higher
        # lane); key is the mesh device index, or None single-device.
        self._holds: dict = {}
        self._stats: dict[str, _LaneStats] = {}

    # -- lane resolution -----------------------------------------------------
    def lane_for(self, subsystem: str, lane: str | None = None) -> str:
        """Lane identity for a submission.  An explicit ``lane``
        override wins only when it names a registered lane label;
        anything else falls back to the subsystem, and subsystems
        outside the registry collapse into the shared default lane."""
        if lane is not None and lane in sigcache.LANES:
            return lane
        if subsystem in sigcache.LANES:
            return subsystem
        return DEFAULT_LANE

    def priority(self, label: str) -> int:
        if not self.enabled:
            return 0
        return sigcache.lane_priority(label)

    def note_enqueue(self, win, label: str) -> None:
        """Stamp scheduling fields on a window entering the queue."""
        win.lane = label
        win.prio = self.priority(label)
        win.seq = self._seq
        self._seq += 1
        win.enqueued_at = self._clock()
        win.held_since = None

    # -- ordering ------------------------------------------------------------
    def _eff_prio(self, win, now: float) -> int:
        """Priority class after deadline promotion: a window older than
        its lane's declared p99 target jumps every normal class."""
        if not self.enabled:
            return 0
        if now - win.enqueued_at > latledger.target_for(win.lane):
            return _PROMOTED
        return win.prio

    def next_unstaged(self, windows, now: float):
        """The unstaged window the staging thread should parse/pack
        next: most urgent effective class first, FIFO within it."""
        best = None
        best_key = None
        for w in windows:
            if w.staged or w.abandoned:
                continue
            key = (self._eff_prio(w, now), w.seq)
            if best_key is None or key < best_key:
                best, best_key = w, key
        return best

    def _eligible(self, windows, device_index, now: float):
        """Staged, undispatched lane-head windows for this device,
        each tagged with its effective priority.  Lane heads are per
        device: mesh windows are pinned to a chip at submit, and
        publication (not dispatch) enforces per-lane result order, so a
        lane's head on another chip never blocks this one."""
        lane_seen: set = set()
        out = []
        for w in windows:  # submission order == seq order
            if w.abandoned or w.result is not None:
                continue
            if device_index is not None and w.device_index != device_index:
                continue
            if w.lane in lane_seen:
                continue
            if w.dispatching:
                # In flight (a watchdog-replaced thread can see its
                # predecessor's wedged window): skip without blocking
                # the lane — parked results publish in lane order.
                continue
            lane_seen.add(w.lane)
            if not w.staged:
                # Within a lane staging is FIFO, so an unstaged lane
                # head means nothing later in that lane is staged
                # either; the lane waits.
                continue
            out.append((self._eff_prio(w, now), w))
        return out

    def _drr_pick(self, cands):
        """Deficit round-robin among equal-priority lane heads.

        ``cands`` is [(lane, window)] with one entry per lane.  A lane
        is served when its accumulated deficit covers the head window's
        signature count; otherwise it gains a quantum and the cursor
        rotates.  Deficits persist across picks; ``_gc_deficits``
        clears a lane's balance when it drains."""
        labels = sorted(lbl for lbl, _ in cands)
        heads = dict(cands)
        guard = 0
        while True:
            lbl = labels[self._rr_idx % len(labels)]
            w = heads[lbl]
            need = max(1, len(w.items))
            d = self._deficit.get(lbl, 0.0)
            # The flat guard bounds rotation at the worst case (a
            # max-batch window against the minimum quantum) so a
            # misconfigured quantum degrades to round-robin, never to
            # an unbounded spin.
            if d >= need or guard >= 1024:
                self._deficit[lbl] = max(0.0, d - need)
                self._rr_idx += 1
                return w
            self._deficit[lbl] = d + self.quantum
            self._rr_idx += 1
            guard += 1

    def _gc_deficits(self, windows) -> None:
        live = {w.lane for w in windows if w.result is None}
        for lbl in [l for l in self._deficit if l not in live]:
            del self._deficit[lbl]

    def pick_dispatch(self, windows, device_index, now: float):
        """Choose the staged window a free device should take.

        Returns ``(window, holding)``.  ``(None, True)`` means the
        device should stay idle (cause ``sched_hold``): a strictly
        higher-priority window is actively staging and the hold budget
        has not expired.  ``(None, False)`` means nothing to do."""
        self._gc_deficits(windows)
        elig = self._eligible(windows, device_index, now)
        if not elig:
            self._holds.pop(device_index, None)
            return None, False
        best_class = min(p for p, _ in elig)
        # Hold the device for a more urgent window mid-staging?
        if self.enabled and self.hold_s > 0:
            urgent_staging = any(
                not w.staged and not w.abandoned
                and getattr(w, "staging_active", False)
                and (device_index is None
                     or w.device_index == device_index)
                and self._eff_prio(w, now) < best_class
                for w in windows)
            if urgent_staging:
                since = self._holds.setdefault(device_index, now)
                if now - since < self.hold_s:
                    return None, True
        self._holds.pop(device_index, None)
        cands = [(w.lane, w) for p, w in elig if p == best_class]
        if len(cands) == 1:
            return cands[0][1], False
        # FIFO among promoted windows: fairness already satisfied by
        # the promotion deadline itself.
        if best_class == _PROMOTED:
            return min((w for _, w in cands), key=lambda w: w.seq), False
        return self._drr_pick(cands), False

    def holding(self, device_index) -> bool:
        return device_index in self._holds

    # -- accounting ----------------------------------------------------------
    def note_dispatch(self, win, windows, now: float) -> dict:
        """Book a dispatch under the cv; returns the event payload for
        ``emit`` (call it after releasing the cv)."""
        st = self._stats.setdefault(win.lane, _LaneStats())
        st.windows += 1
        st.sigs += len(win.items)
        held_s = 0.0
        if win.held_since is not None:
            held_s = max(0.0, now - win.held_since)
            st.held_s += held_s
            win.held_since = None
        overtook = 0
        for w in windows:
            if (w is not win and w.seq < win.seq and w.result is None
                    and not w.dispatching and not w.abandoned
                    and w.prio > win.prio):
                overtook += 1
                if w.held_since is None:
                    w.held_since = now
        if overtook:
            st.preemptions += 1
        return {"lane": win.lane, "batch": len(win.items),
                "overtook": overtook, "held_s": held_s,
                "deficit": self._deficit.get(win.lane, 0.0)}

    def emit(self, ev: dict | None) -> None:
        """Publish a dispatch event outside the pipeline cv."""
        if ev is None:
            return
        sm = libmetrics.scheduler_metrics()
        if sm is not None:
            lane = ev["lane"]
            sm.dispatched_windows.labels(lane).inc()
            sm.dispatched_sigs.labels(lane).inc(ev["batch"])
            sm.lane_deficit.labels(lane).set(ev["deficit"])
            if ev["overtook"]:
                sm.preemptions.labels(lane).inc()
            if ev["held_s"]:
                sm.held_seconds.labels(lane).inc(ev["held_s"])
        if ev["overtook"]:
            flightrec.record(flightrec.EV_SCHED_PREEMPT, lane=ev["lane"],
                             batch=ev["batch"], overtook=ev["overtook"])

    # -- window-formation advisory -------------------------------------------
    def seal_due(self, windows, label: str, now: float) -> bool:
        """Should an accumulator (a vote stream, a coalescer) seal its
        in-formation window now instead of batching further?

        True only when the queue holds work from a *different*
        priority class — the preemption signal (higher class queued:
        our bulk should be cut short so it clears fast; lower class
        queued: we should seal now and jump it).  False on an empty
        queue (the accumulator's flush interval IS the designed
        latency; sealing per-item whenever the pipeline goes idle
        would defeat coalescing entirely) and under pure own-class
        backpressure, where batching up is the efficient move."""
        if not self.enabled:
            return False
        pr = self.priority(label)
        for w in windows:
            if w.result is not None or w.dispatching or w.abandoned:
                continue
            if self._eff_prio(w, now) != pr:
                return True
        return False

    # -- introspection -------------------------------------------------------
    def snapshot(self) -> dict:
        """Per-lane counters."""
        return {
            lbl: {"windows": st.windows, "sigs": st.sigs,
                  "preemptions": st.preemptions,
                  "held_s": st.held_s,
                  "deficit": self._deficit.get(lbl, 0.0)}
            for lbl, st in sorted(self._stats.items())
        }
