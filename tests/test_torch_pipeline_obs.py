"""The verify pipeline's accounts in the port (libs/flightrec.py,
libs/metrics.py, libs/trace.py, libs/tracetl.py, libs/devprof.py,
libs/latledger.py) against the JAX package's: the same recorded inputs,
under the same fake clocks, give the same ring contents, histograms,
percentiles, SLO counts, partitions, exposition text and critical
paths.  Pure Python: no device program runs here."""

import gc
import random

import pytest

from cometbft_tpu.libs import devprof as jdevprof
from cometbft_tpu.libs import flightrec as jflightrec
from cometbft_tpu.libs import latledger as jlatledger
from cometbft_tpu.libs import metrics as jmetrics
from cometbft_tpu.libs import trace as jtrace
from cometbft_tpu.libs import tracetl as jtracetl
from cometbft_tpu_torch.libs import devprof, flightrec, latledger
from cometbft_tpu_torch.libs import lockrank as plr
from cometbft_tpu_torch.libs import metrics, trace, tracetl

# (port module, JAX module) pairs each case runs on
PAIRS = {"flightrec": (flightrec, jflightrec),
         "latledger": (latledger, jlatledger),
         "devprof": (devprof, jdevprof), "metrics": (metrics, jmetrics),
         "trace": (trace, jtrace), "tracetl": (tracetl, jtracetl)}


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
    """The port's rank checker in raise mode around each case, as the
    JAX package's tier-1 runs its own."""
    plr.enable("raise")
    yield
    assert plr.violations() == []
    plr.disable()


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _both(name, fn):
    """fn(module, clock) on the port and on the JAX package."""
    port, jax_mod = PAIRS[name]
    return fn(port, FakeClock()), fn(jax_mod, FakeClock())


# -- flight recorder -------------------------------------------------------------

EVENT_KINDS = ("EV_VERIFY_FLUSH", "EV_DEVICE_FALLBACK", "EV_RLC_FALLBACK",
               "EV_CACHE_LOOKUP", "EV_CACHE_INSERT", "EV_PIPELINE_DRAIN",
               "EV_DEVICE_HASH_FALLBACK", "EV_DEVICE_QUARANTINE",
               "EV_DEVICE_PROBE", "EV_WATCHDOG_TIMEOUT", "EV_BROWNOUT",
               "EV_SLO_BURN", "EV_SCHED_PREEMPT")


def test_event_kinds_are_the_jax_packages():
    for kind in EVENT_KINDS:
        assert getattr(flightrec, kind) == getattr(jflightrec, kind)
    assert flightrec.DEFAULT_CAPACITY == jflightrec.DEFAULT_CAPACITY


@pytest.mark.parametrize("capacity, n", [(8, 5), (8, 21), (4096, 300)])
def test_flightrec_ring_matches(capacity, n):
    def run(mod, clk):
        rec = mod.FlightRecorder(capacity=capacity, clock=clk)
        rng = random.Random(n)
        for i in range(n):
            clk.t += rng.random()
            rec.record(getattr(mod, EVENT_KINDS[i % len(EVENT_KINDS)]),
                       batch=i, path=rng.choice(("device", "host")))
        return rec.events(), rec.dump(), rec.summary(), rec.dump_text()

    assert _both("flightrec", run)[0] == _both("flightrec", run)[1]


def test_flightrec_seam_is_free_without_recorder():
    flightrec.set_recorder(None)
    flightrec.record(flightrec.EV_VERIFY_FLUSH, batch=1)   # no-op
    rec = flightrec.FlightRecorder(capacity=2)
    flightrec.set_recorder(rec)
    try:
        flightrec.record(flightrec.EV_BROWNOUT, entered=True)
    finally:
        flightrec.set_recorder(None)
    assert [e["kind"] for e in rec.events()] == ["brownout"]
    with pytest.raises(ValueError):
        flightrec.FlightRecorder(capacity=0)


# -- metrics ---------------------------------------------------------------------

BUNDLES = ("DeviceMetrics", "CacheMetrics", "DevprofMetrics",
           "SchedulerMetrics", "TraceMetrics")


def _jax_series_only(text: str) -> str:
    """The JAX package's exposition less its XLA compile-ledger series,
    which the port has no counterpart for yet."""
    return "\n".join(ln for ln in text.split("\n")
                     if "devprof_compile_" not in ln)


def test_bucket_schemes_are_the_jax_packages():
    assert metrics.BUCKET_SCHEMES == jmetrics.BUCKET_SCHEMES
    assert metrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS


@pytest.mark.parametrize("bundle", BUNDLES)
def test_exposition_text_matches(bundle):
    """Each bundle, driven through the same sequence of series
    operations, exposes the same text."""
    names = sorted(vars(getattr(metrics, bundle)(metrics.Registry())))

    def run(mod, _clk):
        reg = mod.Registry("cometbft_tpu")
        b = getattr(mod, bundle)(reg)
        rng = random.Random(bundle)
        for name in names:
            m = getattr(b, name)
            for _ in range(3):
                labels = [rng.choice(("0", "1", "consensus"))
                          for _ in m.label_names]
                bound = m.labels(*labels) if labels else m
                v = rng.choice((0.0004, 0.02, 1.5, 7.0, 300.0))
                if m.TYPE == "histogram":
                    bound.observe(v)
                elif m.TYPE == "gauge":
                    bound.set(v)
                else:
                    bound.inc(v)
        return reg.expose()

    port, jax_text = _both("metrics", run)
    assert port == _jax_series_only(jax_text)
    assert "# TYPE" in port


def test_metrics_seams_and_label_checks():
    reg = metrics.Registry()
    c = reg.counter("x", "y_total", "help", labels=("a",))
    with pytest.raises(ValueError):
        c.labels("1", "2")
    for setter, getter, cls in (
            (metrics.set_device_metrics, metrics.device_metrics,
             metrics.DeviceMetrics),
            (metrics.set_cache_metrics, metrics.cache_metrics,
             metrics.CacheMetrics),
            (metrics.set_devprof_metrics, metrics.devprof_metrics,
             metrics.DevprofMetrics),
            (metrics.set_scheduler_metrics, metrics.scheduler_metrics,
             metrics.SchedulerMetrics)):
        b = cls(reg)
        setter(b)
        try:
            assert getter() is b
        finally:
            setter(None)
        assert getter() is None


# -- stage spans and the timeline -------------------------------------------------

def _spans(mod):
    tr = mod.StageTracer()
    tr.record("blocksync", "device", 0.5, end=1.0, fields={"inflight": 2})
    tr.record("blocksync", "collect", 0.4, end=1.2)
    tr.record("blocksync", "host_pack", 0.25, end=1.3)
    tr.record("light", "device", 0.1, end=2.0)
    return tr


def test_stage_tracer_matches():
    port, jax_tr = _spans(trace), _spans(jtrace)
    assert port.snapshot() == jax_tr.snapshot()
    assert port.intervals() == jax_tr.intervals()
    for a, b in (("device", "collect"), ("device", "host_pack"),
                 ("collect", "apply")):
        assert port.overlap_seconds("blocksync", a, b) == \
            jax_tr.overlap_seconds("blocksync", a, b)
    assert port.overlap_seconds("blocksync", "device", "collect") == \
        pytest.approx(0.2)
    assert trace.PIPELINE_STAGES == jtrace.PIPELINE_STAGES


def _timeline(mod, clk, seed):
    """Two nodes' timelines of proposal -> collect / host_pack / device /
    apply -> commit heights, with overlapping spans and flows."""
    rng = random.Random(seed)
    tls = {}
    for node in ("n0", "n1"):
        tl = mod.Timeline(node, capacity=256, clock=clk)
        t = 10.0
        for h in range(1, 6):
            tl.instant("consensus", "proposal", t=t, height=h)
            for stage in ("collect", "host_pack", "device", "device_hash",
                          "host_splice", "apply", "gossip_wait"):
                a = t + rng.random()
                tl.span("blocksync", stage, a, a + rng.random(), height=h)
            clk.t = t + 0.3
            ctx = tl.ctx(h, 0)
            tl.send("p2p", "block_part", ctx, height=h)
            clk.t = t + 0.4
            tl.recv("p2p", "block_part", ctx)
            t += 2.0 + rng.random()
            tl.instant("consensus", "commit", t=t, height=h)
        tls[node] = tl
    return tls


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_critical_path_and_perfetto_match(seed):
    def run(mod, clk):
        tls = _timeline(mod, clk, seed)
        counters = [(10.5, "occupancy_pct/dev0", 100.0),
                    (11.0, "occupancy_pct/dev0", 0.0)]
        tr = mod.perfetto_trace(tls, counters=counters)
        return tr, mod.critical_path(tr), {n: tl.dump_text()
                                            for n, tl in tls.items()}

    (port_tr, port_cp, port_txt), (jax_tr, jax_cp, jax_txt) = \
        _both("tracetl", run)
    assert port_tr == jax_tr
    assert port_cp == jax_cp
    assert port_txt == jax_txt
    for row in port_cp["per_height"]:
        assert sum(row["segments"].values()) == \
            pytest.approx(row["wall_seconds"], abs=2e-6)


def test_timeline_seam_and_ctx_fields():
    assert tracetl.ctx_fields(("n0", 5, 0, 3)) == \
        jtracetl.ctx_fields(("n0", 5, 0, 3))
    assert tracetl.ctx_fields(None) == {} == tracetl.ctx_fields(7)
    assert tracetl.STAGE_SEGMENTS == jtracetl.STAGE_SEGMENTS

    class Owner:
        timeline = None

    owner = Owner()
    assert tracetl.active(owner) is None
    tl = tracetl.Timeline("n0")
    owner.timeline = tl
    with tracetl.span_for(owner, "blocksync", "host_pack", height=4):
        pass
    ev = tl.events()
    assert [(e["ph"], e["sub"], e["name"], e["height"]) for e in ev] == \
        [("span", "blocksync", "host_pack", 4)]


# -- devprof ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_devprof_accounts_match_and_partition_exactly(seed):
    """The same advance schedule on both recorders: the same accounts,
    samples and summary, and busy plus every idle cause sums to the
    accounted wall clock exactly."""
    def run(mod, clk):
        rec = mod.DevprofRecorder(sample_capacity=64, clock=clk)
        rng = random.Random(seed)
        states = (mod.BUSY,) + mod.IDLE_CAUSES
        for dev in ("0", "1"):
            rec.attach(dev, t=clk.t)
        for i in range(120):
            clk.t += rng.choice((0.001, 0.01, 0.25, 0.0))
            rec.advance(rng.choice(("0", "1")), rng.choice(states),
                        path=rng.choice((None, "device", "host", "probe")))
            rec.counter("pipeline_queue_depth", rng.randrange(4))
        snap = rec.snapshot()
        return (snap["devices"], snap["samples"], rec.counter_samples(),
                mod.occupancy_summary(snap))

    port, jax_out = _both("devprof", run)
    assert port == jax_out
    for acct in port[0].values():
        parts = acct["busy_seconds"] + sum(acct["idle_seconds"].values())
        assert parts == pytest.approx(acct["wall_seconds"], abs=1e-5)
    assert devprof.IDLE_CAUSES == jdevprof.IDLE_CAUSES
    assert devprof.BUSY_PATHS == jdevprof.BUSY_PATHS


def test_devprof_exact_partition_unrounded():
    clk = FakeClock(0.0)
    rec = devprof.DevprofRecorder(clock=clk)
    rec.attach("0")
    for dt, st in ((0.3, devprof.BUSY), (0.1, devprof.IDLE_STAGING),
                   (0.2, devprof.IDLE_NO_WORK), (0.4, devprof.BUSY)):
        clk.t += dt
        rec.advance("0", st, path="device")
    acct = rec._accounts["0"]
    assert acct.busy_seconds + sum(acct.idle_seconds.values()) == \
        acct.wall_seconds()
    assert "compile" not in rec.snapshot()
    assert "dev0: occupancy 70.0%" in rec.dump_text()
    clk.t -= 0.5                        # a clock step back re-anchors
    assert rec.advance("0", devprof.BUSY) == 0.0
    assert min(acct.idle_seconds.values()) >= 0.0
    rec.clear()
    assert rec.snapshot()["devices"] == {}


def test_devprof_metrics_driven_like_the_jax_package():
    def run(mod, clk):
        m = mod is devprof and metrics or jmetrics
        reg = m.Registry("cometbft_tpu")
        m.set_devprof_metrics(m.DevprofMetrics(reg))
        try:
            rec = mod.DevprofRecorder(clock=clk)
            rec.attach("0")
            for dt, st in ((1.0, mod.BUSY), (0.5, mod.IDLE_STAGING),
                           (0.25, mod.IDLE_BACKPRESSURE)):
                clk.t += dt
                rec.advance("0", st)
        finally:
            m.set_devprof_metrics(None)
        return reg.expose()

    port, jax_text = _both("devprof", run)
    assert port == _jax_series_only(jax_text)
    assert 'cometbft_tpu_devprof_occupancy_ratio{device="0"} 0.571429' \
        in port


# -- latency ledger --------------------------------------------------------------

STAMPS = ("stage_start", "stage_end", "dispatch", "compute_end")


def _ledger(mod, clk, seed, capacity=64):
    rec = mod.LatLedgerRecorder(capacity=capacity, clock=clk)
    rng = random.Random(seed)
    consumers = ("consensus", "blocksync", "light", "lightserve",
                 "evidence", "crypto")
    for i in range(90):
        clk.t += rng.random() * 0.01
        req = rec.submit(rng.randrange(1, 200),
                         consumer=rng.choice(consumers))
        for name in rng.sample(STAMPS, rng.randrange(len(STAMPS) + 1)):
            clk.t += rng.choice((0.0002, 0.003, 0.04, 0.7))
            req.stamp(name)
        clk.t += rng.random() * 0.2
        if i % 11 == 10:
            req.resolve_coalesced()
        else:
            req.resolve(rng.choice(mod.PATHS[:-1]))
        req.resolve("device")                 # a second resolve: no row
    return rec


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_latledger_matches(seed):
    """Rows, per-consumer histograms and percentiles, SLO counts and the
    p99 counter track, for the same stamped requests."""
    def run(mod, clk):
        rec = _ledger(mod, clk, seed)
        return (rec.rows(), rec.consumers(), rec.slo.snapshot(),
                rec.counter_samples(), rec.dump(), rec.dump_text())

    port, jax_out = _both("latledger", run)
    assert port == jax_out
    for row in port[0]:
        assert row["wall"] == sum(row["segs"].values())
        assert set(row["segs"]) <= set(latledger.SEGMENTS)
    assert latledger.BUCKETS == jlatledger.BUCKETS
    assert latledger.DEFAULT_SLO_TARGETS == jlatledger.DEFAULT_SLO_TARGETS


def test_latledger_ring_overflow_and_burn_events():
    def run(mod, clk):
        fr = (flightrec if mod is latledger else jflightrec)
        events = fr.FlightRecorder(clock=clk)
        fr.set_recorder(events)
        try:
            rec = _ledger(mod, clk, 7, capacity=16)
        finally:
            fr.set_recorder(None)
        return (rec.recorded, len(rec), rec.dump()["dropped"],
                [e for e in events.events() if e["kind"] == "slo_burn"])

    port, jax_out = _both("latledger", run)
    assert port == jax_out
    assert port[0] == 90 and port[1] == 16 and port[3]


def test_lat_histogram_merge_and_quantile():
    rng = random.Random(5)
    vals = [rng.random() * 2 for _ in range(200)]
    hs = []
    for mod in (latledger, jlatledger):
        a, b = mod.LatHistogram(), mod.LatHistogram()
        for i, v in enumerate(vals):
            (a if i % 2 else b).observe(v)
        m = a.merge(b)
        hs.append((m.snapshot(), [m.quantile(q) for q in
                                  (0.0, 0.5, 0.9, 0.99, 1.0)]))
    assert hs[0] == hs[1]
    with pytest.raises(ValueError):
        latledger.LatHistogram().merge(latledger.LatHistogram((1.0,)))
    assert latledger.LatHistogram().quantile(0.5) == 0.0


def test_latledger_seam_off_without_recorder():
    latledger.set_recorder(None)
    assert latledger.submit(4, consumer="consensus") is None
    assert latledger.target_for("blocksync") == \
        jlatledger.target_for("blocksync")
    assert latledger.target_for("crypto") == latledger.DEFAULT_TARGET_S
