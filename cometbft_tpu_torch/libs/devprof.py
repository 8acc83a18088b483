"""Per-device time accounting: the port's copy of
`cometbft_tpu.libs.devprof`.

Every pipeline dispatch thread (crypto/dispatch.py) drives a per-device
account through `advance`, giving every instant since the device
attached to exactly one state: BUSY (a window was dispatching) or one
of the idle causes:

  staging       the next window's host work (host_pack / host_splice)
                had not finished when the device went looking
  backpressure  windows exist but none are dispatchable for this
                device (depth-K slots held by other devices' windows,
                or computed windows waiting on in-order publication)
  no_work       the submit queue was empty (fully cached windows
                resolve at submit and never reach a device)
  drain         the pipeline (or this mesh device) drains to the host
                after a device error
  quarantine    the device is out of rotation (crypto/devhealth.py)
  sched_hold    the QoS scheduler holds the device idle for a more
                urgent window that is still staging

Each account keeps one `mark`; `advance(state, now)` gives [mark, now)
to one bucket and moves the mark, so busy + idle seconds sum to the
accounted wall clock exactly, by construction.

The JAX package's second ledger, XLA compile time, has no counterpart
here yet: the port's first-use cost is the kernels' build
(ops/_build.py).

With no recorder installed the hot paths pay one module-global read
and an `is None` test.  Accounts and counter samples use
``time.perf_counter``, the timeline clock.
"""

from __future__ import annotations

import time

from . import lockrank

BUSY = "busy"
IDLE_STAGING = "staging"
IDLE_BACKPRESSURE = "backpressure"
IDLE_NO_WORK = "no_work"
IDLE_DRAIN = "drain"
IDLE_QUARANTINE = "quarantine"
# the QoS scheduler (crypto/sched.py) is deliberately keeping this
# chip idle: an urgent lane's window is mid-staging and dispatching
# the staged bulk candidate now would make the urgent window wait a
# whole indivisible bulk dispatch — a bounded hold
# (crypto/sched.DEFAULT_HOLD_S), distinct from backpressure because the
# operator should read it as policy, not as a starved feed path
IDLE_SCHED_HOLD = "sched_hold"
IDLE_CAUSES = (IDLE_STAGING, IDLE_BACKPRESSURE, IDLE_NO_WORK,
               IDLE_DRAIN, IDLE_QUARANTINE, IDLE_SCHED_HOLD)
STATES = (BUSY,) + IDLE_CAUSES

# the closed vocabulary of busy paths (the pipeline's resolution paths
# and its probes)
BUSY_PATHS = frozenset({"device", "host", "cache", "drain", "error",
                        "probe"})

DEFAULT_SAMPLE_CAPACITY = 16384


class DeviceAccount:
    """One device's mark-advance time partition.  Not locked — the
    owning DevprofRecorder serializes access."""

    __slots__ = ("device", "attached_at", "mark", "busy_seconds",
                 "busy_by_path", "idle_seconds", "dispatches")

    def __init__(self, device: str, now: float):
        self.device = device
        self.attached_at = now
        self.mark = now
        self.busy_seconds = 0.0
        # path -> seconds within busy: "device" is chip time, "host"
        # is the dispatch thread running a below-threshold window on
        # the CPU (the chip itself is free; consumers that want chip
        # occupancy alone read busy_by_path["device"])
        self.busy_by_path: dict[str, float] = {}
        self.idle_seconds = {c: 0.0 for c in IDLE_CAUSES}
        self.dispatches = 0

    def advance(self, state: str, now: float,
                path: str | None = None) -> float:
        """Assign [mark, now) to `state` and move the mark; returns the
        slice length.  The partition invariant lives here: every
        accounted instant lands in exactly one bucket."""
        dt = now - self.mark
        if dt < 0.0:                 # clock went backwards: re-anchor
            self.mark = now
            return 0.0
        if state == BUSY:
            self.busy_seconds += dt
            key = path or "device"
            self.busy_by_path[key] = self.busy_by_path.get(key, 0.0) + dt
            self.dispatches += 1
        else:
            self.idle_seconds[state] = \
                self.idle_seconds.get(state, 0.0) + dt
        self.mark = now
        return dt

    def wall_seconds(self) -> float:
        return self.mark - self.attached_at

    def snapshot(self) -> dict:
        wall = self.wall_seconds()
        return {
            "busy_seconds": self.busy_seconds,
            "busy_by_path": dict(self.busy_by_path),
            "idle_seconds": dict(self.idle_seconds),
            "wall_seconds": wall,
            "occupancy": (self.busy_seconds / wall) if wall > 0 else 0.0,
            "dispatches": self.dispatches,
        }


class DevprofRecorder:
    """Thread-safe per-device accounts + occupancy/queue counter-track
    samples (bounded ring)."""

    def __init__(self, sample_capacity: int = DEFAULT_SAMPLE_CAPACITY,
                 clock=time.perf_counter):
        if sample_capacity <= 0:
            raise ValueError("capacity must be positive")
        self.sample_capacity = sample_capacity
        self._clock = clock
        self._mtx = lockrank.RankedLock("devprof.ring")
        self._accounts: dict[str, DeviceAccount] = {}
        # counter-track samples: (t, track, value) ring, same
        # recorded/dropped discipline as flightrec
        self._samples: list = [None] * sample_capacity
        self._sampled = 0
        self._last_value: dict[str, float] = {}

    # -- device accounts ---------------------------------------------------

    def attach(self, device: str, t: float | None = None) -> None:
        """Open an account for `device` (idempotent): accounting — and
        the exact-partition window — starts at the attach instant."""
        now = t if t is not None else self._clock()
        with self._mtx:
            if device not in self._accounts:
                self._accounts[device] = DeviceAccount(device, now)
                self._sample_locked(now, "occupancy_pct/dev%s" % device,
                                    0.0)

    def advance(self, device: str, state: str,
                path: str | None = None,
                t: float | None = None) -> float:
        """Attribute everything since this device's mark to `state`
        (BUSY or an idle cause) and move the mark.  Auto-attaches on
        first sight.  Drives the DevprofMetrics seam and the occupancy
        counter track incrementally; returns the slice length."""
        now = t if t is not None else self._clock()
        with self._mtx:
            acct = self._accounts.get(device)
            if acct is None:
                acct = self._accounts[device] = DeviceAccount(device,
                                                              now)
            start = acct.mark
            dt = acct.advance(state, now, path=path)
            if dt > 0.0:
                # the counter track is a step function: the level over
                # [start, now) was 100 iff busy; only level CHANGES
                # store a sample, so a long all-busy run costs two
                self._sample_locked(
                    start, "occupancy_pct/dev%s" % device,
                    100.0 if state == BUSY else 0.0)
            busy = acct.busy_seconds
            wall = acct.wall_seconds()
        if dt > 0.0:
            from . import metrics as libmetrics
            dm = libmetrics.devprof_metrics()
            if dm is not None:
                if state == BUSY:
                    dm.busy_seconds.labels(device).add(dt)
                else:
                    dm.idle_seconds.labels(device, state).add(dt)
                if wall > 0:
                    dm.occupancy.labels(device).set(busy / wall)
        return dt

    # -- counter tracks ----------------------------------------------------

    def _sample_locked(self, t: float, track: str, value: float) -> None:
        if self._last_value.get(track) == value:
            return
        self._last_value[track] = value
        seq = self._sampled
        self._samples[seq % self.sample_capacity] = (t, track, value)
        self._sampled = seq + 1

    def counter(self, track: str, value: float,
                t: float | None = None) -> None:
        """Record one counter-track sample (queue depth, in-flight
        windows, ...) for the Perfetto export; deduplicates repeats of
        the same level."""
        now = t if t is not None else self._clock()
        with self._mtx:
            self._sample_locked(now, track, float(value))

    def counter_samples(self) -> list[tuple]:
        """Retained (t, track, value) samples, oldest first — the
        `counters=` input of tracetl.perfetto_trace."""
        with self._mtx:
            n = self._sampled
            kept = min(n, self.sample_capacity)
            return [self._samples[(n - kept + i) % self.sample_capacity]
                    for i in range(kept)]

    # -- reading -----------------------------------------------------------

    def snapshot(self) -> dict:
        """Per-device partitions and the sample totals."""
        with self._mtx:
            devices = {d: a.snapshot()
                       for d, a in sorted(self._accounts.items())}
            samples = {"recorded": self._sampled,
                       "dropped": self._sampled
                       - min(self._sampled, self.sample_capacity)}
        for d in devices.values():
            for k in ("busy_seconds", "wall_seconds", "occupancy"):
                d[k] = round(d[k], 6)
            d["busy_by_path"] = {k: round(v, 6)
                                 for k, v in d["busy_by_path"].items()}
            d["idle_seconds"] = {k: round(v, 6)
                                 for k, v in d["idle_seconds"].items()}
        return {"devices": devices, "samples": samples}

    def dump(self) -> dict:
        return self.snapshot()

    def dump_text(self) -> str:
        s = self.snapshot()
        lines = ["devprof: %d device(s) (%d samples, %d dropped)"
                 % (len(s["devices"]), s["samples"]["recorded"],
                    s["samples"]["dropped"])]
        for dev, d in s["devices"].items():
            idle = " ".join("%s=%.3fs" % (c, d["idle_seconds"].get(c, 0.0))
                            for c in IDLE_CAUSES)
            lines.append(
                "  dev%s: occupancy %.1f%% busy=%.3fs wall=%.3fs "
                "dispatches=%d idle[%s]"
                % (dev, 100.0 * d["occupancy"], d["busy_seconds"],
                   d["wall_seconds"], d["dispatches"], idle))
        return "\n".join(lines)

    def clear(self) -> None:
        with self._mtx:
            self._accounts = {}
            self._samples = [None] * self.sample_capacity
            self._sampled = 0
            self._last_value = {}


def occupancy_summary(snapshot: dict) -> dict:
    """Aggregate one recorder snapshot into the bench extras:
    device_occupancy_fraction (busy / wall over every device) and
    host_bound_fraction (the staging idle share — wall the chips spent
    waiting on host pack/splice)."""
    busy = wall = staging = 0.0
    causes = {c: 0.0 for c in IDLE_CAUSES}
    for d in (snapshot.get("devices") or {}).values():
        busy += d["busy_seconds"]
        wall += d["wall_seconds"]
        for c in IDLE_CAUSES:
            causes[c] += d["idle_seconds"].get(c, 0.0)
    staging = causes[IDLE_STAGING]
    return {
        "device_occupancy_fraction": round(busy / wall, 6)
        if wall > 0 else 0.0,
        "host_bound_fraction": round(staging / wall, 6)
        if wall > 0 else 0.0,
        "idle_cause_seconds": {c: round(v, 6)
                               for c, v in causes.items()},
        "busy_seconds": round(busy, 6),
        "wall_seconds": round(wall, 6),
    }


# -- process-wide seam -------------------------------------------------------
# The pipeline's dispatch threads sit below node wiring and report
# through this, exactly like flightrec.record / metrics.device_metrics.
_recorder: DevprofRecorder | None = None


def set_recorder(r: DevprofRecorder | None) -> None:
    global _recorder
    _recorder = r


def recorder() -> DevprofRecorder | None:
    return _recorder
