"""Causal timeline: the port's copy of `cometbft_tpu.libs.tracetl`.

One bounded event record per node (a `Timeline`) stitches stage spans
(libs/trace.py intervals), flight-recorder events and the verify
pipeline's window lifecycle into one trace.  A trace context is a plain
tuple ``(origin, height, round, seq)``; the pipeline copies a window's
context onto its spans (`ctx_fields`).  The node's wire carry of the
context comes with the node.

Exports are Chrome/Perfetto ``trace_event`` JSON: one "process" per
node, one "thread" per subsystem, "X" events for spans, "i" instants,
"s"/"f" flow events for send/recv pairs.  `critical_path()` decomposes
each committed height's proposal->commit window into
gossip/collect/host_pack/device/apply segments by a prioritized sweep
over the merged spans: a partition of the window, so the segments sum
to the measured wall time.

With no timeline installed the hot paths pay one attribute or global
read and an ``is None`` test; one event is a lock, an integer bump and
a list store.  Timelines record ``time.perf_counter()``, flightrec
``time.monotonic()``: both CLOCK_MONOTONIC on Linux, so their
records share one axis.
"""

from __future__ import annotations

import time

from . import lockrank

DEFAULT_CAPACITY = 65536

# event phases (internal record shape, pre-Perfetto)
PH_SPAN = "span"
PH_INSTANT = "instant"
PH_SEND = "send"
PH_RECV = "recv"

# stage-name -> critical-path segment; anything unmapped (and all
# uncovered wall time) falls into the "gossip" residual
STAGE_SEGMENTS = {
    "device": "device", "device_wait": "device",
    "host_pack": "host_pack", "verify_dispatch": "host_pack",
    "apply": "apply", "store": "apply", "commit": "apply",
    "collect": "collect", "decode": "collect", "fetch": "collect",
    "propose": "collect", "prevote": "collect", "precommit": "collect",
    # device-hash verify mode (crypto/dispatch.py): host_pack's
    # successors — staging shrinks to splice+pack, hashing joins the
    # device dispatch.  Mapping INTO the existing segments keeps the
    # critical-path sweep's exact-sum property and every downstream
    # consumer (perf gate, PERF.md tables) comparable across modes.
    "host_splice": "host_pack", "device_hash": "device",
}
# highest-priority segment wins when spans overlap in the sweep
SEGMENT_PRIORITY = ("device", "host_pack", "apply", "collect")
SEGMENTS = SEGMENT_PRIORITY + ("gossip",)


def make_ctx(origin: str, height: int, round_: int, seq: int) -> tuple:
    return (origin, int(height), int(round_), int(seq))


def ctx_fields(ctx) -> dict:
    """Flatten a trace context into the origin/height/round keys the
    flight recorder and timeline dumps cross-reference by."""
    if not isinstance(ctx, tuple) or len(ctx) != 4:
        return {}
    return {"origin": ctx[0], "height": ctx[1], "round": ctx[2]}


class Timeline:
    """Bounded ring of per-node timeline events.

    Same ring discipline as FlightRecorder: `recorded` counts every
    event ever seen, the ring keeps the last `capacity`, `dropped` is
    the difference.  Thread safe — consensus state thread, gossip
    threads, and the pipeline's staging/device threads all record into
    one node's instance.
    """

    def __init__(self, node: str = "node",
                 capacity: int = DEFAULT_CAPACITY,
                 clock=time.perf_counter):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.node = node
        self.capacity = capacity
        self._clock = clock
        self._mtx = lockrank.RankedLock("tracetl.ring")
        self._ring: list = [None] * capacity
        self._recorded = 0
        self._ctx_seq = 0

    # -- recording ---------------------------------------------------------
    def _store(self, t, ph, subsystem, name, dur, ctx, fields) -> None:
        with self._mtx:
            seq = self._recorded
            self._ring[seq % self.capacity] = (
                seq, t, ph, subsystem, name, dur, ctx, fields)
            self._recorded = seq + 1

    def span(self, subsystem: str, stage: str, start: float,
             end: float, **fields) -> None:
        """A completed stage interval [start, end] on this node."""
        self._store(start, PH_SPAN, subsystem, stage,
                    end - start, None, fields or None)

    def instant(self, subsystem: str, name: str, t: float | None = None,
                **fields) -> None:
        """A point event (proposal receipt, commit, step change)."""
        self._store(t if t is not None else self._clock(),
                    PH_INSTANT, subsystem, name, None, None,
                    fields or None)

    def send(self, subsystem: str, name: str, ctx, **fields) -> None:
        self._store(self._clock(), PH_SEND, subsystem, name, None,
                    ctx, fields or None)

    def recv(self, subsystem: str, name: str, ctx, **fields) -> None:
        self._store(self._clock(), PH_RECV, subsystem, name, None,
                    ctx, fields or None)

    def ctx(self, height: int, round_: int) -> tuple:
        """Mint a trace context originating at this node."""
        with self._mtx:
            self._ctx_seq += 1
            seq = self._ctx_seq
        return make_ctx(self.node, height, round_, seq)

    # -- reading -----------------------------------------------------------
    def __len__(self) -> int:
        with self._mtx:
            return min(self._recorded, self.capacity)

    @property
    def recorded(self) -> int:
        with self._mtx:
            return self._recorded

    @property
    def dropped(self) -> int:
        with self._mtx:
            return self._recorded - min(self._recorded, self.capacity)

    def events(self) -> list[dict]:
        """Oldest-to-newest snapshot of the retained events."""
        with self._mtx:
            n = self._recorded
            kept = min(n, self.capacity)
            raw = [self._ring[(n - kept + i) % self.capacity]
                   for i in range(kept)]
        out = []
        for (seq, t, ph, sub, name, dur, ctx, fields) in raw:
            e = {"seq": seq, "t": t, "ph": ph, "sub": sub, "name": name}
            if dur is not None:
                e["dur"] = dur
            if ctx is not None:
                e["ctx"] = list(ctx)
            if fields:
                e.update(fields)
            out.append(e)
        return out

    def dump(self) -> dict:
        evs = self.events()
        return {
            "node": self.node,
            "recorded": self.recorded,
            "dropped": self.recorded - len(evs),
            "capacity": self.capacity,
            "events": evs,
        }

    def dump_text(self) -> str:
        d = self.dump()
        lines = [f"timeline {d['node']}: {d['recorded']} recorded, "
                 f"{d['dropped']} dropped (capacity {d['capacity']})"]
        for e in d["events"]:
            extra = " ".join(f"{k}={v}" for k, v in e.items()
                             if k not in ("seq", "t", "ph", "sub", "name"))
            lines.append(f"  #{e['seq']:<6} t={e['t']:.6f} "
                         f"{e['ph']:<7} {e['sub']}.{e['name']} {extra}")
        return "\n".join(lines)

    def clear(self) -> None:
        with self._mtx:
            self._ring = [None] * self.capacity
            self._recorded = 0


# -- span context manager ----------------------------------------------------

class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _TimedSpan:
    __slots__ = ("_tl", "_subsystem", "_stage", "_t0", "_fields")

    def __init__(self, tl: Timeline, subsystem: str, stage: str, fields):
        self._tl = tl
        self._subsystem = subsystem
        self._stage = stage
        self._fields = fields

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tl.span(self._subsystem, self._stage, self._t0,
                      time.perf_counter(), **(self._fields or {}))
        return False


# -- process-wide seam -------------------------------------------------------
# Layers below node wiring (crypto/dispatch, crypto/votestream) report
# through this, exactly like flightrec.record / trace.span.  Node-owned
# layers (consensus state, reactors) carry a per-object `timeline`
# attribute that overrides the seam, so N simnet nodes in one process
# stay attributable.
_timeline: Timeline | None = None


def set_timeline(tl: Timeline | None) -> None:
    global _timeline
    _timeline = tl


def timeline() -> Timeline | None:
    return _timeline


def active(owner=None) -> Timeline | None:
    """The timeline `owner` records to: its own attribute if assigned,
    else the process-wide seam, else None (record nothing)."""
    tl = getattr(owner, "timeline", None) if owner is not None else None
    return tl if tl is not None else _timeline


def span_for(owner, subsystem: str, stage: str, **fields):
    """Context manager emitting a timeline span; free when neither the
    owner nor the process seam has a timeline installed."""
    tl = active(owner)
    if tl is None:
        return _NULL_SPAN
    return _TimedSpan(tl, subsystem, stage, fields or None)


def instant(subsystem: str, name: str, **fields) -> None:
    """Record an instant into the process-wide timeline; free when
    none is set."""
    tl = _timeline
    if tl is None:
        return
    tl.instant(subsystem, name, **fields)


# -- Perfetto export ---------------------------------------------------------

def _flow_id(ctx) -> str:
    return "%s/%d/%d/%d" % tuple(ctx)


def perfetto_trace(timelines, counters=None) -> dict:
    """Merge per-node timelines into one Chrome/Perfetto trace_event
    JSON object: pid per node, tid per subsystem, X/i slices, and
    s->f flow events for every cross-node context edge.

    `timelines` is a {name: Timeline} dict or an iterable of Timeline
    (named by their .node).  `counters` is an optional iterable of
    (t, track, value) samples (DevprofRecorder.counter_samples());
    they render as "C" counter tracks under a dedicated "devprof"
    process so occupancy/queue-depth trajectories sit on the same time
    axis as the spans they explain."""
    if isinstance(timelines, dict):
        items = sorted(timelines.items())
    else:
        items = sorted((tl.node, tl) for tl in timelines)

    dumps = [(name, tl.dump()) for name, tl in items]
    counters = list(counters) if counters is not None else []
    t0 = min((e["t"] for _, d in dumps for e in d["events"]),
             default=None)
    if counters:
        ct0 = min(t for t, _, _ in counters)
        t0 = ct0 if t0 is None else min(t0, ct0)
    if t0 is None:
        t0 = 0.0

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 3)

    events = []
    tids: dict[tuple, int] = {}
    for pid, (name, d) in enumerate(dumps, start=1):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": name}})
        for e in d["events"]:
            key = (pid, e["sub"])
            tid = tids.get(key)
            if tid is None:
                tid = tids[key] = len(tids) + 1
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": tid,
                               "args": {"name": e["sub"]}})
            args = {k: v for k, v in e.items()
                    if k not in ("seq", "t", "ph", "sub", "name",
                                 "dur", "ctx")}
            ctx = e.get("ctx")
            if ctx:
                args.update(ctx_fields(tuple(ctx)))
            base = {"name": e["name"], "cat": e["sub"], "pid": pid,
                    "tid": tid, "ts": us(e["t"]), "args": args}
            if e["ph"] == PH_SPAN:
                events.append({**base, "ph": "X",
                               "dur": round(e["dur"] * 1e6, 3)})
            elif e["ph"] == PH_INSTANT:
                events.append({**base, "ph": "i", "s": "t"})
            else:                       # send / recv: slice + flow event
                direction = e["ph"]
                events.append({**base, "ph": "X", "dur": 1.0,
                               "name": f"{direction}:{e['name']}"})
                if ctx:
                    flow = {"ph": "s" if direction == PH_SEND else "f",
                            "cat": "causal", "name": e["name"],
                            "id": _flow_id(tuple(ctx)), "pid": pid,
                            "tid": tid, "ts": base["ts"]}
                    if direction == PH_RECV:
                        flow["bp"] = "e"
                    events.append(flow)
    if counters:
        cpid = len(dumps) + 1
        events.append({"ph": "M", "name": "process_name", "pid": cpid,
                       "tid": 0, "args": {"name": "devprof"}})
        for t, track, value in counters:
            events.append({"ph": "C", "name": track, "pid": cpid,
                           "tid": 0, "ts": us(t),
                           "args": {"value": value}})
    return {
        "displayTimeUnit": "ms",
        "traceEvents": events,
        "metadata": {
            "nodes": [name for name, _ in dumps],
            "dropped": {name: d["dropped"] for name, d in dumps},
            "counters": len(counters),
        },
    }


# -- critical-path decomposition ---------------------------------------------

def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def _sweep(spans: list[tuple], lo: float, hi: float) -> dict:
    """Prioritized-sweep PARTITION of [lo, hi]: every instant belongs
    to the highest-priority segment with an active span there, or to
    the gossip residual — so the segment sum equals hi - lo exactly.
    `spans` is a list of (start, end, segment)."""
    rank = {seg: i for i, seg in enumerate(SEGMENT_PRIORITY)}
    clipped = [(max(s, lo), min(e, hi), seg) for s, e, seg in spans
               if min(e, hi) > max(s, lo)]
    bounds = sorted({lo, hi, *(s for s, _, _ in clipped),
                     *(e for _, e, _ in clipped)})
    out = {seg: 0.0 for seg in SEGMENTS}
    for a, b in zip(bounds, bounds[1:]):
        if b <= lo or a >= hi:
            continue
        active_segs = [seg for s, e, seg in clipped if s <= a and e >= b]
        best = min(active_segs, key=lambda s: rank[s], default=None)
        out[best if best is not None else "gossip"] += b - a
    return out


def critical_path(trace: dict) -> dict:
    """Decompose each committed height's proposal->commit window into
    gossip/collect/host_pack/device/apply segments from an exported
    Perfetto trace (the `perfetto_trace` shape).

    The window opens at the EARLIEST "proposal" instant for the height
    on any node and closes at the LATEST "commit" instant — i.e. the
    cluster-wide wall clock a client would observe.  Spans from every
    node compete in one sweep (device work anywhere counts as device
    time), which is the right reading for "is the device the
    bottleneck yet?".  Deterministic: a pure function of the trace."""
    proposals: dict[int, float] = {}
    commits: dict[int, float] = {}
    spans: list[tuple] = []
    for e in trace.get("traceEvents", []):
        # only "i" instants and "X" slices feed the sweep; any other
        # phase ("M" metadata, "s"/"f" flows, "C" counter tracks, or
        # phases a future exporter invents) passes through untouched,
        # as do malformed events missing ts/name
        if not isinstance(e, dict):
            continue
        ph = e.get("ph")
        if not isinstance(e.get("ts"), (int, float)) \
                or not isinstance(e.get("name"), str):
            continue
        if ph == "i":
            h = (e.get("args") or {}).get("height")
            if not isinstance(h, int):
                continue
            t = e["ts"] / 1e6
            if e["name"] == "proposal":
                if h not in proposals or t < proposals[h]:
                    proposals[h] = t
            elif e["name"] == "commit":
                if h not in commits or t > commits[h]:
                    commits[h] = t
        elif ph == "X":
            seg = STAGE_SEGMENTS.get(e["name"])
            if seg is not None:
                t = e["ts"] / 1e6
                spans.append((t, t + e.get("dur", 0.0) / 1e6, seg))

    per_height = []
    for h in sorted(commits):
        lo, hi = proposals.get(h), commits[h]
        if lo is None or hi <= lo:
            continue
        segs = _sweep(spans, lo, hi)
        wall = round(hi - lo, 6)
        rounded = {k: round(v, 6) for k, v in segs.items()}
        # the residual segment absorbs per-segment rounding error so
        # the partition sums EXACTLY to wall_seconds (the invariant
        # fleet reports assert); may dip a microsecond below zero
        rounded["gossip"] = round(
            wall - sum(v for k, v in rounded.items() if k != "gossip"),
            6)
        per_height.append({
            "height": h,
            "wall_seconds": wall,
            "segments": rounded,
        })

    by_seg = {seg: sorted(r["segments"][seg] for r in per_height)
              for seg in SEGMENTS}
    walls = [r["wall_seconds"] for r in per_height]
    total_wall = sum(walls)
    total_device = sum(by_seg["device"])
    summary = {
        "heights": len(per_height),
        "wall_seconds_total": round(total_wall, 6),
        "device_share": round(total_device / total_wall, 6)
        if total_wall else 0.0,
        "segments": {
            seg: {
                "total_seconds": round(sum(vals), 6),
                "p50": round(_percentile(vals, 0.50), 6),
                "p99": round(_percentile(vals, 0.99), 6),
            } for seg, vals in by_seg.items()},
    }
    return {"per_height": per_height, "summary": summary}
