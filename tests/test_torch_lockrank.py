"""The port's lock ranks and concurrency sanitizer seams
(libs/lockrank.py) against the JAX package's: the ranks of every lock
the verify pipeline brings, raise and warn modes, RankedRLock /
RankedCondition, the cross-thread edge table, and the thread- and
future-leak registries.  Then the whole pipeline with every account
installed, in raise mode."""

import gc
import threading

import pytest

from cometbft_tpu.libs import lockrank as jlr
from cometbft_tpu_torch.crypto import dispatch as vd
from cometbft_tpu_torch.crypto import sigcache
from cometbft_tpu_torch.libs import devprof, flightrec, latledger
from cometbft_tpu_torch.libs import lockrank as plr
from cometbft_tpu_torch.libs import metrics, trace, tracetl

SIDES = (plr, jlr)

# the ranks this slice adds, as the JAX package declares them
NEW_RANKS = {"dispatch.default": 370, "dispatch.cv": 400,
             "devhealth.registry": 420, "devprof.ring": 490,
             "latledger.ring": 495, "flightrec.ring": 500,
             "tracetl.ring": 510, "metrics.registry": 530,
             "metrics.series": 540, "trace.stage": 520,
             "service.lifecycle": 550, "consensus.state": 20,
             "consensus.peerstate": 30, "consensus.ticker": 40,
             "evidence.pool": 50, "mempool.clist": 60,
             "mempool.cache": 70, "pubsub": 170, "autofile": 410}


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
def _restore_checkers():
    """Each case installs its own checkers; the ones the test run had
    (the JAX package's, from its conftest) come back after it."""
    saved = [(lr, lr.checker(), lr.sanitizer_enabled()) for lr in SIDES]
    yield
    for lr, checker, sanitizer in saved:
        lr._checker = checker
        lr.set_sanitizer(sanitizer)


def test_ranks_are_the_jax_packages():
    for name, rank in NEW_RANKS.items():
        assert plr.LOCK_RANKS[name] == rank
    for name, rank in plr.LOCK_RANKS.items():
        assert jlr.LOCK_RANKS[name] == rank
        assert (name in plr.MULTI_OK) == (name in jlr.MULTI_OK)
    with pytest.raises(ValueError):
        plr.RankedLock("p2p.addrbook")        # not a lock of the port


def _inversion(lr):
    """Take a rank-400 lock, then try a rank-370 one: the message."""
    lr.enable("raise")
    outer = lr.RankedLock("dispatch.default")
    cv = lr.RankedCondition(name="dispatch.cv")
    with cv:
        with pytest.raises(lr.LockRankError) as ei:
            outer.acquire()
        assert not outer.locked()             # raised before blocking
        assert outer.acquire(blocking=False)  # a try-lock cannot wait
        outer.release()
    lr.disable()
    return str(ei.value).split("\n")[0]


def test_inversion_raises_before_blocking_as_the_jax_package():
    assert _inversion(plr) == _inversion(jlr)
    assert "rank inversion: acquiring 'dispatch.default' (rank 370)" in \
        _inversion(plr)


def _edge_report(lr):
    """Thread T takes devprof.ring then flightrec.ring (an edge); the
    main thread then takes them the other way round: the report carries
    T's stack."""
    lr.enable("raise")
    a = lr.RankedLock("devprof.ring")
    b = lr.RankedLock("flightrec.ring")

    def first_order():
        with a:
            with b:
                pass

    th = threading.Thread(target=first_order)
    th.start()
    th.join()
    with b:
        with pytest.raises(lr.LockRankError) as ei:
            a.acquire()
    lr.disable()
    return str(ei.value)


def test_cross_thread_edge_carries_the_other_stack():
    port, jax_msg = _edge_report(plr), _edge_report(jlr)
    assert port.split("\n")[0] == jax_msg.split("\n")[0]
    for msg in (port, jax_msg):
        assert "stack that established the opposite order " \
               "('devprof.ring' -> 'flightrec.ring')" in msg
        assert "first_order" in msg


@pytest.mark.parametrize("lr", SIDES, ids=["port", "jax"])
def test_rlock_reentry_and_lock_self_deadlock(lr):
    lr.enable("raise")
    reg = lr.RankedRLock("devhealth.registry")
    with reg:
        with reg:                            # reentrant: fine
            pass
    lock = lr.RankedLock("latledger.ring")
    with lock:
        with pytest.raises(lr.LockRankError, match="self-deadlock"):
            lock.acquire()
    assert lr.checker().held_names() == []


@pytest.mark.parametrize("lr", SIDES, ids=["port", "jax"])
def test_condition_wait_drops_its_lock_and_flags_others(lr):
    lr.enable("raise")
    cv = lr.RankedCondition(name="dispatch.cv")
    with cv:
        assert lr.checker().held_names() == ["dispatch.cv"]
        assert cv.wait(timeout=0.001) is False
        assert lr.checker().held_names() == ["dispatch.cv"]
        assert cv.wait_for(lambda: True, timeout=0.001)
    outer = lr.RankedLock("dispatch.default")
    with outer:
        with cv:
            with pytest.raises(lr.LockRankError,
                               match="cv wait on 'dispatch.cv' while "
                                     "holding"):
                cv.wait(timeout=0.001)
    with pytest.raises(TypeError):
        lr.RankedCondition(lock=threading.Lock())
    with pytest.raises(ValueError):
        lr.RankedCondition()


def test_warn_mode_records_once_per_site():
    out = []
    for lr in SIDES:
        c = lr.enable("warn")
        a, b = lr.RankedLock("metrics.series"), lr.RankedLock("trace.stage")
        for _ in range(2):
            with a:
                with b:
                    pass
        out.append([v.split(" at ")[0] for v in c.violations])
        lr.disable()
        assert lr.violations() == []
    assert out[0] == out[1] and len(out[0]) == 1


def _leak(lr):
    lr.set_sanitizer(True)
    lr.clear_leaked_futures()
    fut = lr.TrackedFuture()
    fut.set_exception(RuntimeError("dropped"))
    kept = lr.TrackedFuture()
    kept.set_exception(RuntimeError("read"))
    assert isinstance(kept.exception(), RuntimeError)
    del fut, kept
    gc.collect()
    leaked = lr.leaked_futures()
    lr.clear_leaked_futures()
    return leaked


def test_future_leak_registry():
    port, jax_leaks = _leak(plr), _leak(jlr)
    assert len(port) == len(jax_leaks) == 1
    assert port[0].split("\n")[0] == jax_leaks[0].split("\n")[0]
    assert plr.leaked_futures() == []


def test_thread_leak_registry_and_sanctioned_default_pipeline():
    baseline = set(threading.enumerate())
    stop = threading.Event()
    th = threading.Thread(target=stop.wait, name="leaky")
    th.start()
    try:
        assert plr.leaked_threads(baseline, grace_s=0.05) == [th]
    finally:
        stop.set()
        th.join()
    assert plr.leaked_threads(baseline, grace_s=0.05) == []
    pipe = vd.default_pipeline(device="cpu")
    try:
        assert vd.default_pipeline(device="cpu") is pipe
        with pytest.raises(ValueError):
            vd.default_pipeline(device="cpu:0")
        owned = plr.sanctioned_threads()
        assert pipe._staging in owned and pipe._device in owned
    finally:
        pipe.stop()
    assert plr.leaked_threads(baseline, grace_s=1.0) == []


def test_pipeline_with_every_account_runs_clean_in_raise_mode():
    """Submitters, the staging thread, the dispatch thread and the
    watchdog, with the verdict cache, metrics, flight recorder, devprof,
    latency ledger, stage tracer and timeline installed: no inversion,
    no leaked thread or future."""
    plr.enable("raise")
    plr.set_sanitizer(True)
    baseline = set(threading.enumerate())
    reg = metrics.Registry("cometbft_tpu")
    seams = ((metrics.set_device_metrics, metrics.DeviceMetrics(reg)),
             (metrics.set_cache_metrics, metrics.CacheMetrics(reg)),
             (metrics.set_devprof_metrics, metrics.DevprofMetrics(reg)),
             (metrics.set_scheduler_metrics, metrics.SchedulerMetrics(reg)),
             (flightrec.set_recorder, flightrec.FlightRecorder()),
             (devprof.set_recorder, devprof.DevprofRecorder()),
             (latledger.set_recorder, latledger.LatLedgerRecorder()),
             (trace.set_tracer, trace.StageTracer()),
             (tracetl.set_timeline, tracetl.Timeline("n0")))
    for setter, obj in seams:
        setter(obj)
    sigcache.set_enabled(True)
    sigcache.reset()
    calls = []

    def judge(win):
        calls.append(len(win.items))
        if len(calls) == 2:
            raise RuntimeError("injected")   # one drain, through _fault
        return True, [True] * len(win.items)

    items = [(bytes([i]) * 32, b"m%d" % i, bytes([i]) * 64)
             for i in range(6)]
    try:
        with vd.VerifyPipeline(depth=2, device="cpu", host_workers=1,
                               dispatch_fn=judge,
                               dispatch_deadline_s=0.2) as pipe:
            hs = [pipe.submit(items[i:i + 2], subsystem=sub,
                              device_threshold=1)
                  for i, sub in zip((0, 2, 4), ("blocksync", "consensus",
                                                "light"))]
            for h in hs:
                h.result(timeout=30)
            again = pipe.submit(items[:2], subsystem="blocksync")
            assert again.path == "cache"
    finally:
        for setter, _ in seams:
            setter(None)
        sigcache.set_enabled(None)
        sigcache.reset()
    gc.collect()
    assert plr.violations() == []
    assert plr.leaked_futures() == []
    assert plr.leaked_threads(baseline, grace_s=1.0) == []
    assert "cometbft_tpu_device_pipeline_drains 1" in reg.expose()
