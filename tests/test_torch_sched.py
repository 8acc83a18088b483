"""The port's QoS scheduler (crypto/sched.py) against the JAX package's,
step by step: the same window sequence and the same fake clock fed to
both give the same staging and dispatch picks, the same holds, the same
seal advisories, the same dispatch events and an equal snapshot.  Bare
window stand-ins, no threads and no sleeps."""

import gc
import random

import pytest

from cometbft_tpu.crypto import sched as jqs
from cometbft_tpu.libs import flightrec as jflightrec
from cometbft_tpu.libs import metrics as jmetrics
from cometbft_tpu_torch.crypto import sched as qs
from cometbft_tpu_torch.crypto import sigcache
from cometbft_tpu_torch.libs import flightrec
from cometbft_tpu_torch.libs import lockrank as plr
from cometbft_tpu_torch.libs import metrics

SUBSYSTEMS = ("consensus", "blocksync", "light", "lightserve", "evidence",
              "crypto", "pipeline", "bench")


@pytest.fixture(scope="module", autouse=True)
def _frozen_heap():
    """Move the objects alive after the imports (torch's, JAX's) out of
    the collector's reach for this module: the per-test gc.collect() of
    the leak checks then walks only what the tests made."""
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()


@pytest.fixture(autouse=True)
def _port_lock_ranks():
    plr.enable("raise")
    yield
    assert plr.violations() == []
    plr.disable()


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class W:
    """The fields the scheduler reads of a dispatch._Window."""

    def __init__(self, items: int, device_index: int):
        self.items = [None] * items
        self.staged = False
        self.abandoned = False
        self.dispatching = False
        self.staging_active = False
        self.result = None
        self.device_index = device_index
        self.lane = qs.DEFAULT_LANE
        self.prio = 0
        self.seq = 0
        self.enqueued_at = 0.0
        self.held_since = None


def _ops(seed, n=160, devices=(None,)):
    """A seeded operation sequence: enqueue, stage, mark staging, pick
    for a device, resolve, advance the clock, ask for a seal advisory."""
    rng = random.Random(seed)
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.25:
            ops.append(("enq", rng.choice(SUBSYSTEMS), rng.choice(
                (1, 4, 64, 300)), rng.choice((None, None, "consensus",
                                              "blocksync", "nope")),
                rng.choice(devices)))
        elif r < 0.4:
            ops.append(("stage",))
        elif r < 0.47:
            ops.append(("staging",))
        elif r < 0.67:
            ops.append(("pick", rng.choice(devices)))
        elif r < 0.8:
            ops.append(("resolve",))
        elif r < 0.92:
            ops.append(("advance", rng.choice((0.0005, 0.001, 0.003, 0.2,
                                               0.6, 1.5))))
        else:
            ops.append(("seal", rng.choice(SUBSYSTEMS)))
    return ops


def _run(mod, ops, **kw):
    """Feed `ops` to mod.QosScheduler; the trace of every decision, by
    window tag (its enqueue order)."""
    clk = FakeClock()
    sch = mod.QosScheduler(clock=clk, **kw)
    windows, trace, enqueued = [], [], 0
    for op in ops:
        kind = op[0]
        if kind == "enq":
            _, sub, items, lane, dev = op
            w = W(items, 0 if dev is None else dev)
            w.tag = enqueued
            enqueued += 1
            label = sch.lane_for(sub, lane)
            sch.note_enqueue(w, label)
            windows.append(w)
            trace.append(("enq", label, w.prio, w.seq))
        elif kind in ("stage", "staging"):
            w = sch.next_unstaged(windows, clk())
            trace.append((kind, None if w is None else w.tag))
            if w is not None:
                if kind == "stage":
                    w.staged, w.staging_active = True, False
                else:
                    w.staging_active = True
        elif kind == "pick":
            win, holding = sch.pick_dispatch(windows, op[1], clk())
            ev = None
            if win is not None:
                win.dispatching = True
                ev = sch.note_dispatch(win, windows, clk())
            trace.append(("pick", op[1], None if win is None
                          else win.tag, holding, ev,
                          sch.holding(op[1])))
        elif kind == "resolve":
            live = [w for w in windows if w.dispatching
                    and w.result is None]
            if live:
                live[0].result = (True, [], "host")
                windows.remove(live[0])
            trace.append(("resolve", live[0].tag if live else None))
        elif kind == "advance":
            clk.t += op[1]
        else:
            trace.append(("seal", op[1], sch.seal_due(windows, op[1],
                                                      clk())))
    trace.append(("snapshot", sch.snapshot()))
    return trace


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("config", [
    {}, {"enabled": False}, {"hold_s": 0.0}, {"quantum": 8},
    {"hold_s": 0.005, "quantum": 1}])
def test_single_device_decisions_match(seed, config):
    ops = _ops(seed)
    assert _run(qs, ops, **config) == _run(jqs, ops, **config)


@pytest.mark.parametrize("seed", range(4))
def test_mesh_decisions_match(seed):
    """Windows pinned to device 0 or 1, picks per device: per-device lane
    heads and per-device holds."""
    ops = _ops(100 + seed, devices=(0, 1))
    for config in ({}, {"hold_s": 0.002, "quantum": 16}):
        assert _run(qs, ops, **config) == _run(jqs, ops, **config)


def test_lane_registry_is_the_jax_packages():
    from cometbft_tpu.crypto import sigcache as jsigcache

    assert sigcache.LANES == jsigcache.LANES
    assert sigcache.CONSUMERS == jsigcache.CONSUMERS
    for label in SUBSYSTEMS:
        assert sigcache.lane_priority(label) == \
            jsigcache.lane_priority(label)
    assert (qs.DEFAULT_QUANTUM, qs.DEFAULT_HOLD_S, qs.DEFAULT_LANE) == \
        (jqs.DEFAULT_QUANTUM, jqs.DEFAULT_HOLD_S, jqs.DEFAULT_LANE)


def _enq(sch, sub, items=1, staged=True, dev=0):
    w = W(items, dev)
    sch.note_enqueue(w, sch.lane_for(sub))
    w.staged = staged
    return w


def test_vote_overtakes_queued_bulk_and_books_held_time():
    clk = FakeClock()
    sch = qs.QosScheduler(hold_s=0, clock=clk)
    bulk, vote = _enq(sch, "blocksync", 64), _enq(sch, "consensus")
    windows = [bulk, vote]
    win, holding = sch.pick_dispatch(windows, None, clk())
    assert win is vote and not holding
    vote.dispatching = True
    ev = sch.note_dispatch(vote, windows, clk())
    assert ev["overtook"] == 1 and bulk.held_since == clk()
    clk.t += 0.25
    assert sch.pick_dispatch(windows, None, clk())[0] is bulk
    assert sch.note_dispatch(bulk, windows, clk())["held_s"] == \
        pytest.approx(0.25)
    snap = sch.snapshot()
    assert snap["consensus"]["preemptions"] == 1
    assert snap["blocksync"]["held_s"] == pytest.approx(0.25)


def test_device_holds_for_a_staging_urgent_window_then_expires():
    clk = FakeClock()
    sch = qs.QosScheduler(hold_s=0.002, clock=clk)
    bulk = _enq(sch, "blocksync", 64)
    vote = _enq(sch, "consensus", staged=False)
    vote.staging_active = True
    assert sch.pick_dispatch([bulk, vote], None, clk()) == (None, True)
    assert sch.holding(None)
    clk.t += 0.003
    assert sch.pick_dispatch([bulk, vote], None, clk()) == (bulk, False)
    assert not sch.holding(None)


def test_overdue_bulk_is_promoted_ahead_of_votes():
    clk = FakeClock()
    sch = qs.QosScheduler(hold_s=0, clock=clk)
    bulk = _enq(sch, "blocksync", 8)
    clk.t += 0.6                          # past blocksync's 0.5 s target
    vote = _enq(sch, "consensus")
    assert sch.pick_dispatch([bulk, vote], None, clk())[0] is bulk
    assert not qs.QosScheduler(enabled=False, clock=clk).seal_due(
        [bulk, vote], "consensus", clk())


def test_emit_records_preemption_and_drives_metrics_as_the_jax_package():
    """The same two dispatches emitted on both schedulers: the same
    flight-recorder events and scheduler series."""
    out = []
    for mod, fr, mt in ((qs, flightrec, metrics),
                        (jqs, jflightrec, jmetrics)):
        clk = FakeClock()
        sch = mod.QosScheduler(hold_s=0, clock=clk)
        bulk, vote = _enq(sch, "blocksync", 4), _enq(sch, "consensus")
        windows = [bulk, vote]
        rec = fr.FlightRecorder(clock=clk)
        reg = mt.Registry()
        fr.set_recorder(rec)
        mt.set_scheduler_metrics(mt.SchedulerMetrics(reg))
        try:
            sch.emit(None)
            for _ in range(2):
                clk.t += 0.1
                win, _ = sch.pick_dispatch(windows, None, clk())
                win.dispatching = True
                sch.emit(sch.note_dispatch(win, windows, clk()))
        finally:
            fr.set_recorder(None)
            mt.set_scheduler_metrics(None)
        out.append((rec.events(), reg.expose()))
    assert out[0] == out[1]
    assert [e["lane"] for e in out[0][0]] == ["consensus"]
    assert 'cometbft_sched_held_seconds_total{lane="blocksync"} 0.1' \
        in out[0][1]
