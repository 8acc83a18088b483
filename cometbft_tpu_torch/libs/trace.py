"""Stage-span tracing: the port's copy of `cometbft_tpu.libs.trace`.

Product paths open spans around each stage; a process-wide StageTracer
accumulates (count, seconds) per (subsystem, stage) and keeps a bounded
ring of (start, end) intervals, so overlap between stages (the verify
pipeline's host_pack of window N+1 against window N's device span) is
read from the record.  With a metrics bundle (libs/metrics.TraceMetrics)
every span is also a histogram observation.

With no tracer installed a span is a shared no-op object: one global
read and an `is None` test.
"""

from __future__ import annotations

import time

from . import lockrank

# canonical stage names for the blocksync ingest pipeline; other
# subsystems (light) reuse the subset that applies to them
BLOCKSYNC_STAGES = ("decode", "verify_dispatch", "device", "apply",
                    "store")
# extra stages emitted by the overlapped verify pipeline
# (crypto/dispatch.py): collect runs in the submitter, host_pack in
# the staging thread — concurrent with the previous window's device
PIPELINE_STAGES = ("collect", "host_pack")
LIGHT_STAGES = ("fetch", "verify_dispatch", "device", "store")

# interval ring size per tracer: enough to prove overlap across a
# bench run without unbounded growth on long-lived nodes
MAX_INTERVALS = 1024


class StageTracer:
    """Accumulates span durations per (subsystem, stage); optionally
    mirrors every observation into a metrics.TraceMetrics bundle.
    Also keeps a bounded ring of (start, end) INTERVALS per span so
    concurrency between stages — the overlapped pipeline's whole
    claim — is provable from the record, not asserted."""

    def __init__(self, metrics=None):
        self._mtx = lockrank.RankedLock("trace.stage")
        self._totals: dict[tuple[str, str], list] = {}
        self._intervals: list = []      # (sub, stage, t0, t1, fields)
        self.dropped_intervals = 0      # ring overflow, no longer silent
        self.metrics = metrics

    def record(self, subsystem: str, stage: str, seconds: float,
               end: float | None = None, fields=None) -> None:
        t1 = end if end is not None else time.perf_counter()
        overflow = 0
        with self._mtx:
            t = self._totals.setdefault((subsystem, stage), [0, 0.0])
            t[0] += 1
            t[1] += seconds
            self._intervals.append(
                (subsystem, stage, t1 - seconds, t1, fields))
            if len(self._intervals) > MAX_INTERVALS:
                overflow = len(self._intervals) - MAX_INTERVALS
                del self._intervals[:overflow]
                self.dropped_intervals += overflow
        if self.metrics is not None:
            self.metrics.stage_duration_seconds.labels(
                subsystem, stage).observe(seconds)
            if overflow:
                self.metrics.intervals_dropped.add(overflow)

    def intervals(self, subsystem: str | None = None,
                  stage: str | None = None) -> list[dict]:
        """Retained span intervals, oldest first."""
        with self._mtx:
            raw = list(self._intervals)
        return [{"subsystem": sub, "stage": st, "start": t0, "end": t1,
                 **(dict(f) if f else {})}
                for (sub, st, t0, t1, f) in raw
                if (subsystem is None or sub == subsystem)
                and (stage is None or st == stage)]

    def overlap_seconds(self, subsystem: str, stage_a: str,
                        stage_b: str) -> float:
        """Total wall-clock during which a stage_a span and a stage_b
        span of `subsystem` ran CONCURRENTLY — the proof that a device
        span overlapped the next window's collect/pack span."""
        a = self.intervals(subsystem, stage_a)
        b = self.intervals(subsystem, stage_b)
        total = 0.0
        for ia in a:
            for ib in b:
                lo = max(ia["start"], ib["start"])
                hi = min(ia["end"], ib["end"])
                if hi > lo:
                    total += hi - lo
        return total

    def snapshot(self) -> dict:
        """{"subsystem.stage": {"count": n, "seconds": s}} — the shape
        a run reports beside its rates."""
        with self._mtx:
            return {
                f"{sub}.{stage}": {"count": c, "seconds": round(s, 6)}
                for (sub, stage), (c, s) in sorted(self._totals.items())}

    def reset(self) -> None:
        with self._mtx:
            self._totals.clear()


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _TimedSpan:
    __slots__ = ("_tracer", "_subsystem", "_stage", "_t0", "_fields")

    def __init__(self, tracer: StageTracer, subsystem: str, stage: str,
                 fields=None):
        self._tracer = tracer
        self._subsystem = subsystem
        self._stage = stage
        self._fields = fields

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer.record(self._subsystem, self._stage,
                            t1 - self._t0, end=t1, fields=self._fields)
        return False


# process-wide tracer seam (same pattern as metrics.set_device_metrics)
_tracer: StageTracer | None = None


def set_tracer(t: StageTracer | None) -> None:
    global _tracer
    _tracer = t


def tracer() -> StageTracer | None:
    return _tracer


def span(subsystem: str, stage: str, **fields):
    """Context manager timing one stage; free when no tracer is set.
    Keyword fields (e.g. inflight=, depth=) land on the interval
    record so pipeline depth is visible next to the timing."""
    t = _tracer
    if t is None:
        return _NULL_SPAN
    return _TimedSpan(t, subsystem, stage, fields or None)
