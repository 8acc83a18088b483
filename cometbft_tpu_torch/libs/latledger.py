"""Per-request verify-latency ledger: the port's copy of
`cometbft_tpu.libs.latledger`.

Every verify request is stamped at submit, and its submit -> resolve
wall time is split into an exact partition (segments sum to the wall by
construction):

| segment | meaning |
|---|---|
| ``queue_wait``   | backpressure before staging + the staged-but-undispatched wait |
| ``coalesce_wait``| the whole life of a deduplicated duplicate |
| ``host_pack``    | staging: parse + columnar pack/splice |
| ``device``       | device dispatch compute (device-path windows) |
| ``host_verify``  | host/drain/error-path compute |
| ``cache``        | resolved from the signature-verdict cache |
| ``publish``      | compute done -> the caller's future resolved |

Rows are keyed by the ``sigcache`` consumer label, each consumer with
its own log-bucketed histogram.  The ring is bounded and thread-safe,
with ``recorded`` / ``dropped`` totals; with no recorder installed the
hot paths pay one module-global read and an ``is None`` test.

``SLOTracker`` adds per-consumer p99 targets with multi-window burn
rates (a short window catches a spike, a long one proves it sustained);
a trip records an ``EV_SLO_BURN`` flight-recorder event and a sustained
burn dumps the flight recorder to the log.

The row ring holds ``DEFAULT_CAPACITY`` rows (4096) unless the recorder
is made with another ``capacity``; the short-window trip threshold is
``BURN_THRESHOLD`` (14.0) unless the tracker is given its own.
"""

from __future__ import annotations

import bisect
import time

from . import lockrank
from . import metrics as libmetrics

DEFAULT_CAPACITY = 4096
BURN_THRESHOLD = 14.0

# resolution paths: the pipeline's closed set plus "coalesced" — a
# duplicate attributed to the in-flight original it attached to
PATHS = ("device", "host", "cache", "drain", "error", "coalesced")

# the closed segment vocabulary (module docstring table)
SEGMENTS = ("queue_wait", "coalesce_wait", "host_pack", "device",
            "host_verify", "cache", "publish")

# which segment the compute interval books under, per resolution path
_COMPUTE_SEG = {"device": "device", "host": "host_verify",
                "drain": "host_verify", "error": "host_verify",
                "cache": "cache"}

# wall-seconds bucket bounds shared with the metrics registry's
# closed scheme table — one layout, mergeable across processes
BUCKETS = libmetrics.BUCKET_SCHEMES["verify_latency"]

# declared per-consumer p99 targets (seconds).  Keys come from the
# closed consumer registry (crypto/sigcache.CONSUMERS).  Votes are the
# latency-critical tenant; bulk feeds tolerate an order more.
DEFAULT_SLO_TARGETS = {
    "consensus": 0.050,
    "blocksync": 0.500,
    "light": 0.250,
    "lightserve": 0.250,
    "evidence": 0.250,
}

# consumers with no declared target (the "crypto"/"bench" default
# class) schedule against this bound — the QoS scheduler
# (crypto/sched.py) uses it as the starvation guard for lanes the SLO
# table does not name, so even the lowest class gets dispatched within
# a bounded wait under a sustained higher-priority flood
DEFAULT_TARGET_S = 1.0


def target_for(consumer: str) -> float:
    """Declared p99 target in seconds for a consumer label; labels
    outside DEFAULT_SLO_TARGETS get the DEFAULT_TARGET_S bound."""
    return DEFAULT_SLO_TARGETS.get(consumer, DEFAULT_TARGET_S)


class LatHistogram:
    """Fixed-boundary log-bucket histogram of wall seconds.

    Merge is element-wise addition over identical boundaries, so it is
    associative and commutative by construction — per-consumer
    histograms from different rings (or processes) fold into one.
    """

    __slots__ = ("bounds", "counts", "count", "sum")

    def __init__(self, bounds=BUCKETS):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v

    def merge(self, other: "LatHistogram") -> "LatHistogram":
        if self.bounds != other.bounds:
            raise ValueError("cannot merge histograms with different "
                             "bucket layouts")
        out = LatHistogram(self.bounds)
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.count = self.count + other.count
        out.sum = self.sum + other.sum
        return out

    def quantile(self, q: float) -> float:
        """Upper-bound estimate of the q-quantile (the bucket's upper
        edge; the overflow bucket reports the top boundary)."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank and c:
                return self.bounds[min(i, len(self.bounds) - 1)]
        return self.bounds[-1]

    def snapshot(self) -> dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "count": self.count, "sum": self.sum}


class Request:
    """One in-flight verify request's stamps.  Created by submit(),
    stamped by the pipeline seams, committed exactly once by
    resolve()/resolve_coalesced().  The recorder reference is captured
    at submit so a recorder swap mid-flight cannot split a row."""

    __slots__ = ("rec", "consumer", "n", "t0", "stamps", "done")

    def __init__(self, rec, consumer: str, n: int, t0: float):
        self.rec = rec
        self.consumer = consumer
        self.n = n
        self.t0 = t0
        self.stamps: dict = {}
        self.done = False

    def stamp(self, name: str) -> None:
        self.stamps[name] = self.rec._clock()

    def _partition(self, t_res: float, path: str) -> dict:
        """Fold the stamps into segment seconds.  Each cut clamps into
        [previous cut, t_res], so missing or out-of-order stamps can
        only shrink a segment, never break the partition; the row's
        wall is DEFINED as the sum of its segments (telescoping to
        t_res - t0), which is what makes sum(segs) == wall exact."""
        segs: dict = {}
        upto = self.t0

        def cut(seg: str, t: float) -> None:
            nonlocal upto
            t = min(max(t, upto), t_res)
            if t > upto:
                segs[seg] = segs.get(seg, 0.0) + (t - upto)
                upto = t

        ss = self.stamps.get("stage_start")
        if ss is not None:
            cut("queue_wait", ss)
        se = self.stamps.get("stage_end")
        if se is not None:
            cut("host_pack", se)
        d = self.stamps.get("dispatch")
        if d is not None:
            # staged but not yet dispatched: the head-of-line wait
            # behind other windows is backpressure, same as pre-staging
            cut("queue_wait", d)
        ce = self.stamps.get("compute_end")
        comp = _COMPUTE_SEG.get(path, "host_verify")
        if ce is not None:
            cut(comp, ce)
            cut("publish", t_res)
        else:
            # no compute stamp (cache-at-submit, stopped-path host
            # loop): the remainder IS the compute
            cut(comp, t_res)
        return segs

    def resolve(self, path: str) -> None:
        """Commit this request's row; idempotent (first resolution
        wins — the drain path and a racing device resolve cannot
        double-count)."""
        rec = self.rec
        t_res = rec._clock()
        rec._commit(self, path, self._partition(t_res, path))

    def resolve_coalesced(self) -> None:
        """Commit a duplicate's row: its whole life was spent waiting
        on the original's shared future."""
        rec = self.rec
        t_res = rec._clock()
        wall = max(0.0, t_res - self.t0)
        segs = {"coalesce_wait": wall} if wall > 0.0 else {}
        rec._commit(self, "coalesced", segs)


class _ConsumerStats:
    __slots__ = ("hist", "seg_seconds", "requests", "sigs", "coalesced")

    def __init__(self):
        self.hist = LatHistogram()
        self.seg_seconds = {}
        self.requests = 0
        self.sigs = 0
        self.coalesced = 0


class SLOTracker:
    """Per-consumer p99 targets with multi-window burn-rate accounting.

    An observation is "bad" when its wall exceeds the consumer's
    target; the error budget of a p99 target is 1%.  Burn rate =
    bad-fraction / budget over a window; the tracker trips when the
    SHORT window burns past ``threshold`` while the LONG window burns
    past 1.0 (a spike that is also eating real budget), and calls
    ``on_burn(consumer, info, sustained)`` — sustained=True after
    ``sustain`` consecutive tripping observations, the auto-dump
    signal.  Windows are 1-second buckets in bounded deques; not
    thread-safe on its own (the recorder serializes under its ring
    lock)."""

    ERROR_BUDGET = 0.01

    def __init__(self, targets=None, *, short_s: float = 60.0,
                 long_s: float = 600.0,
                 threshold: float | None = None, sustain: int = 3,
                 clock=time.monotonic, on_burn=None):
        self.targets = dict(DEFAULT_SLO_TARGETS if targets is None
                            else targets)
        self.short_s = float(short_s)
        self.long_s = float(long_s)
        self.threshold = BURN_THRESHOLD if threshold is None \
            else float(threshold)
        self.sustain = max(1, int(sustain))
        self._clock = clock
        self.on_burn = on_burn
        # consumer -> list of [bucket_second, good, bad] (long window)
        self._buckets: dict[str, list] = {}
        self._trips: dict[str, int] = {}
        self.burn_events = 0

    def _rates(self, rows, now: float) -> tuple[float, float]:
        sg = sb = lg = lb = 0
        for sec, good, bad in rows:
            age = now - sec
            if age <= self.long_s:
                lg += good
                lb += bad
                if age <= self.short_s:
                    sg += good
                    sb += bad

        def burn(good: int, bad: int) -> float:
            total = good + bad
            if not total:
                return 0.0
            return (bad / total) / self.ERROR_BUDGET

        return burn(sg, sb), burn(lg, lb)

    def observe(self, consumer: str, wall: float) -> None:
        target = self.targets.get(consumer)
        if target is None:
            return
        now = self._clock()
        rows = self._buckets.setdefault(consumer, [])
        sec = int(now)
        if rows and rows[-1][0] == sec:
            row = rows[-1]
        else:
            row = [sec, 0, 0]
            rows.append(row)
            while rows and now - rows[0][0] > self.long_s:
                rows.pop(0)
        if wall > target:
            row[2] += 1
        else:
            row[1] += 1
        short, long_ = self._rates(rows, now)
        if short >= self.threshold and long_ >= 1.0:
            self._trips[consumer] = self._trips.get(consumer, 0) + 1
            self.burn_events += 1
            if self.on_burn is not None:
                self.on_burn(consumer,
                             {"target_ms": target * 1000.0,
                              "burn_short": round(short, 2),
                              "burn_long": round(long_, 2)},
                             self._trips[consumer] >= self.sustain)
        else:
            self._trips[consumer] = 0

    def snapshot(self) -> dict:
        now = self._clock()
        out = {}
        for consumer, target in sorted(self.targets.items()):
            short, long_ = self._rates(self._buckets.get(consumer, ()),
                                       now)
            out[consumer] = {"target_ms": target * 1000.0,
                             "burn_short": round(short, 2),
                             "burn_long": round(long_, 2),
                             "tripping": self._trips.get(consumer,
                                                         0) > 0}
        return {"consumers": out, "burn_events": self.burn_events,
                "threshold": self.threshold}


class LatLedgerRecorder:
    """Bounded ring of per-request rows + per-consumer aggregates.

    Thread-safe (one ranked lock, leaf-most like the other
    observability rings); every aggregate is recomputable from rows
    alone modulo ring overflow, so ``recorded``/``dropped`` keep the
    overflow honest.  ``counter_samples()`` exposes per-consumer p99
    trajectories in the (t, track, value) shape tracetl's Perfetto
    export merges as counter tracks — level-deduped like devprof's."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock=time.monotonic, slo: SLOTracker | None = None):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._clock = clock
        self._mtx = lockrank.RankedLock("latledger.ring")
        self._ring: list = [None] * capacity
        self._recorded = 0
        self._stats: dict[str, _ConsumerStats] = {}
        self.slo = SLOTracker(clock=clock, on_burn=self._on_burn) \
            if slo is None else slo
        if slo is not None and slo.on_burn is None:
            slo.on_burn = self._on_burn
        self._samples: list = []
        self._samples_dropped = 0
        self._levels: dict[str, float] = {}

    # -- recording ---------------------------------------------------------
    def submit(self, n: int = 1, consumer: str | None = None) -> Request:
        if consumer is None:
            from ..crypto import sigcache

            consumer = sigcache.current_consumer()
        return Request(self, consumer, max(1, int(n)), self._clock())

    def _on_burn(self, consumer: str, info: dict,
                 sustained: bool) -> None:
        from . import flightrec

        flightrec.record(flightrec.EV_SLO_BURN, consumer=consumer,
                         sustained=sustained, **info)
        if sustained:
            rec = flightrec.recorder()
            if rec is not None:
                rec.dump_to_log(
                    f"sustained SLO burn: {consumer} "
                    f"(burn_short={info['burn_short']}, "
                    f"target={info['target_ms']}ms)")

    def _commit(self, req: Request, path: str, segs: dict) -> None:
        wall = sum(segs.values())
        with self._mtx:
            if req.done:
                return
            req.done = True
            seq = self._recorded
            self._ring[seq % self.capacity] = (
                seq, req.t0, req.consumer, path, req.n, wall, segs)
            self._recorded = seq + 1
            st = self._stats.get(req.consumer)
            if st is None:
                st = self._stats[req.consumer] = _ConsumerStats()
            st.hist.observe(wall)
            st.requests += 1
            st.sigs += req.n
            if path == "coalesced":
                st.coalesced += 1
            for k, v in segs.items():
                st.seg_seconds[k] = st.seg_seconds.get(k, 0.0) + v
            p99 = st.hist.quantile(0.99) * 1000.0
            track = f"verify_p99_ms/{req.consumer}"
            if self._levels.get(track) != p99:
                self._levels[track] = p99
                if len(self._samples) >= self.capacity:
                    self._samples.pop(0)
                    self._samples_dropped += 1
                self._samples.append((self._clock(), track, p99))
            self.slo.observe(req.consumer, wall)

    # -- reading -----------------------------------------------------------
    def __len__(self) -> int:
        with self._mtx:
            return min(self._recorded, self.capacity)

    @property
    def recorded(self) -> int:
        with self._mtx:
            return self._recorded

    def rows(self) -> list[dict]:
        """Oldest-to-newest snapshot of the retained rows."""
        with self._mtx:
            n = self._recorded
            kept = min(n, self.capacity)
            raw = [self._ring[(n - kept + i) % self.capacity]
                   for i in range(kept)]
        return [{"seq": seq, "t": t, "consumer": c, "path": p, "n": n_,
                 "wall": wall, "segs": dict(segs)}
                for (seq, t, c, p, n_, wall, segs) in raw]

    def counter_samples(self) -> list[tuple]:
        """(t, track, value) per-consumer p99 trajectory, oldest
        first — the counters= input of tracetl.perfetto_trace."""
        with self._mtx:
            return list(self._samples)

    def consumers(self) -> dict:
        """Per-consumer aggregate snapshot (the dump's core)."""
        with self._mtx:
            out = {}
            for label, st in sorted(self._stats.items()):
                out[label] = {
                    "requests": st.requests,
                    "sigs": st.sigs,
                    "coalesced": st.coalesced,
                    "p50_ms": round(st.hist.quantile(0.50) * 1000, 3),
                    "p99_ms": round(st.hist.quantile(0.99) * 1000, 3),
                    "mean_ms": round(
                        st.hist.sum / st.hist.count * 1000, 3)
                    if st.hist.count else 0.0,
                    "seg_seconds": {k: round(v, 6) for k, v in
                                    sorted(st.seg_seconds.items())},
                    "hist": st.hist.snapshot(),
                }
            return out

    def dump(self) -> dict:
        rows = self.rows()
        return {
            "recorded": self.recorded,
            "dropped": self.recorded - len(rows),
            "capacity": self.capacity,
            "consumers": self.consumers(),
            "slo": self.slo.snapshot(),
            "rows": rows,
        }

    def dump_text(self) -> str:
        d = self.dump()
        lines = [f"latency ledger: {d['recorded']} rows recorded, "
                 f"{d['dropped']} dropped (capacity {d['capacity']})"]
        for label, c in d["consumers"].items():
            total = sum(c["seg_seconds"].values()) or 1.0
            shares = " ".join(
                f"{k}={v / total:.0%}" for k, v in
                c["seg_seconds"].items())
            lines.append(
                f"  {label:<12} n={c['requests']:<7} "
                f"sigs={c['sigs']:<8} p50={c['p50_ms']:.3f}ms "
                f"p99={c['p99_ms']:.3f}ms coalesced={c['coalesced']}")
            lines.append(f"    {shares}")
        slo = d["slo"]
        for label, s in slo["consumers"].items():
            lines.append(
                f"  slo {label:<8} target={s['target_ms']:.0f}ms "
                f"burn_short={s['burn_short']} "
                f"burn_long={s['burn_long']}"
                f"{'  TRIPPING' if s['tripping'] else ''}")
        return "\n".join(lines)

    def clear(self) -> None:
        with self._mtx:
            self._ring = [None] * self.capacity
            self._recorded = 0
            self._stats = {}
            self._samples = []
            self._samples_dropped = 0
            self._levels = {}


# -- process-wide seam -------------------------------------------------------
# same discipline as flightrec/devprof: layers below node wiring stamp
# through this; with nothing installed a submit is one global read.
_recorder: LatLedgerRecorder | None = None


def set_recorder(r: LatLedgerRecorder | None) -> None:
    global _recorder
    _recorder = r


def recorder() -> LatLedgerRecorder | None:
    return _recorder


def submit(n: int = 1, consumer: str | None = None) -> Request | None:
    """Stamp one request at submit time; None when the ledger is off
    (no recorder installed) — every wiring seam guards on that None, so
    the disabled cost is this call."""
    r = _recorder
    if r is None:
        return None
    return r.submit(n, consumer)
