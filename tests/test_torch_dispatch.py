"""The port's verify pipeline (crypto/dispatch.py) on the CPU, mirroring
the JAX package's tests/test_dispatch.py and held against the JAX
package: parallel parse + hash byte for byte, verdict parity, per-lane
ordering, backpressure, empty windows, submit after stop, the drain on
a device fault, the watchdog's quarantine, flap, brownout, the mesh
rotation's quarantine and recovery, mixed-key and cache merges, and
verify_async's raise contract against the serial verify().  Device
dispatches are dispatch_fn stand-ins that judge from the staged parse,
except one small window that goes through the port's real
_device_verify on the plain versions (device="cpu").  No deadline is
longer than 0.2 s, no pool has more than two workers, and every pipeline
is closed in a `with` block."""

import gc
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

from cometbft_tpu.crypto import batch as jcb
from cometbft_tpu.crypto import dispatch as jvd
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import ed25519_ref as jref
from cometbft_tpu.crypto import sigcache as jsigcache
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import canonical as jcanon
from cometbft_tpu.types import validation as jval
from cometbft_tpu.types.timestamp import Timestamp as JTimestamp
from cometbft_tpu.types.validator_set import (Validator as JValidator,
                                              ValidatorSet as JValidatorSet)
from cometbft_tpu_torch.crypto import devhealth
from cometbft_tpu_torch.crypto import dispatch as vd
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import sigcache
from cometbft_tpu_torch.libs import flightrec
from cometbft_tpu_torch.libs import lockrank as plr
from cometbft_tpu_torch.libs import metrics, trace
from cometbft_tpu_torch.ops import ed25519 as tdev
from cometbft_tpu_torch.types import block as tblock
from cometbft_tpu_torch.types import validation as tval
from cometbft_tpu_torch.types.timestamp import Timestamp as TTimestamp
from cometbft_tpu_torch.types.validator_set import (
    Validator as TValidator, ValidatorSet as TValidatorSet)

CPU = "cpu"
DEADLINE = 0.2


@pytest.fixture(scope="module", autouse=True)
def _frozen_heap():
    """Move the objects alive after the imports (torch's, JAX's) out of
    the collector's reach for this module: the per-test gc.collect() of
    the leak checks then walks only what the tests made."""
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _no_dropped_futures():
    """The port's future-leak registry armed for the module: a window
    future collected with an exception nobody read fails it."""
    plr.set_sanitizer(True)
    plr.clear_leaked_futures()
    yield
    gc.collect()
    leaked = plr.leaked_futures()
    plr.set_sanitizer(False)
    plr.clear_leaked_futures()
    assert leaked == []


@pytest.fixture(autouse=True)
def _sanitized():
    """Raise-mode lock ranks and the port's thread-leak registry around
    each case; the verdict caches of both packages empty and off."""
    plr.enable("raise")
    baseline = set(threading.enumerate())
    sigcache.reset()
    sigcache.set_enabled(False)
    jsigcache.reset()
    jsigcache.set_enabled(False)
    yield
    sigcache.set_enabled(None)
    sigcache.reset()
    jsigcache.set_enabled(None)
    jsigcache.reset()
    assert plr.violations() == []
    plr.disable()
    assert plr.leaked_threads(baseline, grace_s=1.0) == []


def make_items(n, seed=0, msg=b"pipeline-item", bad=()):
    """The JAX package's fixture (tests/test_dispatch.py): n (pubkey
    bytes, msg, sig) triples, those in `bad` corrupted."""
    items = []
    for i in range(n):
        priv = jed.PrivKey.generate(bytes([seed & 0xFF, i & 0xFF,
                                           (i >> 8) & 0xFF]) + b"\x05" * 29)
        m = msg + i.to_bytes(4, "little")
        sig = priv.sign(m)
        if i in bad:
            sig = sig[:6] + bytes([sig[6] ^ 1]) + sig[7:]
        items.append((priv.pub_key().bytes(), m, sig))
    return items


def oracle(items):
    """The JAX package's serial verdicts on the same triples."""
    return [jcb.safe_verify(jed.PubKey(pk), m, s) if len(pk) == 32
            else False for pk, m, s in items]


def judge_staged(win):
    """Stand-in device dispatch: the staged parse's structural rejects,
    the JAX package's host verify for the rest (probe windows carry key
    objects)."""
    out = []
    for p, (pk, m, s) in zip(win.parsed, win.items):
        raw = pk if isinstance(pk, (bytes, bytearray)) else pk.bytes()
        out.append(p is not None and jcb.safe_verify(jed.PubKey(raw), m, s))
    return all(out) and bool(out), out


class _NoCudaPath(type(Path())):
    """pathlib's Path on a machine without the CUDA toolkit."""

    def exists(self, *a, **k):
        return self.name != "nvcc" and super().exists(*a, **k)


def wait_until(pred, timeout=10.0):
    ev = threading.Event()
    deadline = timeout
    while deadline > 0:
        if pred():
            return True
        ev.wait(0.005)
        deadline -= 0.005
    return pred()


# -- parse + hash -----------------------------------------------------------------

class TestParseAndHashParallel:
    def test_byte_parity_with_the_jax_package(self):
        items = make_items(700, seed=3, bad=(5, 611))
        items[17] = (items[17][0], items[17][1], b"\xff" * 64)
        items[300] = (b"\x01" * 5, items[300][1], items[300][2])
        cols = [list(c) for c in zip(*items)]
        with ThreadPoolExecutor(max_workers=2) as pool:
            par = vd.parse_and_hash_parallel(*cols, pool=pool, workers=2)
        assert par == jed.parse_and_hash(*cols) == ted.parse_and_hash(*cols)
        assert par[17] is None and par[300] is None

    def test_small_batch_stays_serial(self):
        cols = [list(c) for c in zip(*make_items(8, seed=1))]
        assert vd.parse_and_hash_parallel(*cols, pool=None) == \
            jed.parse_and_hash(*cols)
        assert (vd.PARSE_INLINE_THRESHOLD, vd._MIN_PARALLEL_CHUNK) == \
            (jvd.PARSE_INLINE_THRESHOLD, jvd._MIN_PARALLEL_CHUNK)


# -- verdicts, ordering, backpressure ---------------------------------------------

class TestPipelineVerdicts:
    def test_verdict_parity_good_and_bad(self):
        """Host lane and stand-in device lane, against the JAX package's
        pipeline on the same fixture and the serial oracle."""
        items = make_items(24, seed=7, bad=(3, 20))
        want = oracle(items)
        assert want.count(False) == 2
        with vd.VerifyPipeline(depth=2, device=CPU, host_workers=1) as pipe:
            ok_h, host = pipe.submit(list(items), device_threshold=1 << 30) \
                .result(timeout=30)
        with vd.VerifyPipeline(depth=2, device=CPU, host_workers=1,
                               dispatch_fn=judge_staged) as pipe:
            h = pipe.submit(list(items), device_threshold=1)
            ok_d, dev = h.result(timeout=30)
        with jvd.VerifyPipeline(depth=2, host_workers=1,
                                dispatch_fn=judge_staged) as jpipe:
            jh = jpipe.submit(list(items), device_threshold=1)
            jres = jh.result(timeout=30)
        assert host == dev == want and not ok_h and not ok_d
        assert (ok_d, dev) == jres and h.path == jh.path == "device"

    def test_real_device_verify_on_the_plain_versions(self):
        """One small window (two commits' worth) through the port's real
        crypto/batch._device_verify on device="cpu": the RLC program
        rejects, the per-signature program localizes, and the verdicts
        are ed25519_ref's."""
        items = make_items(12, seed=8, bad=(9,))
        calls = {"rlc": 0, "persig": 0}
        rlc, persig = ted.rlc_verify, tdev.verify_kernel

        def rlc_spy(*a, **k):
            calls["rlc"] += 1
            return rlc(*a, **k)

        def persig_spy(*a, **k):
            calls["persig"] += 1
            return persig(*a, **k)

        ted.rlc_verify, tdev.verify_kernel = rlc_spy, persig_spy
        try:
            with vd.VerifyPipeline(depth=2, device=CPU,
                                   host_workers=1) as pipe:
                h = pipe.submit(list(items), subsystem="blocksync",
                                device_threshold=1)
                ok, verdicts = h.result(timeout=120)
        finally:
            ted.rlc_verify, tdev.verify_kernel = rlc, persig
        assert verdicts == [jref.verify(*t) for t in items]
        assert not ok and verdicts.count(False) == 1
        assert h.path == "device" and calls == {"rlc": 1, "persig": 1}
        assert pipe.device_windows == 1

    def test_ordering_strict_within_a_lane(self):
        release = threading.Event()
        order = []

        def slow_first(win):
            if win.handle.ctx == 0:
                release.wait(timeout=10)
            return True, [True] * len(win.items)

        with vd.VerifyPipeline(depth=4, device=CPU, host_workers=1,
                               dispatch_fn=slow_first) as pipe:
            handles = []
            for w in range(4):
                h = pipe.submit(make_items(2, seed=w), ctx=w,
                                device_threshold=1)
                h.add_done_callback(lambda hh: order.append(hh.ctx))
                handles.append(h)
            assert wait_until(lambda: pipe.staged >= 3)
            release.set()
            for h in handles:
                h.result(timeout=30)
        assert order == [0, 1, 2, 3]

    def test_empty_window_resolves_immediately(self):
        with vd.VerifyPipeline(depth=2, device=CPU, host_workers=1) as pipe:
            assert pipe.submit([]).result(timeout=5) == (False, [])

    def test_submit_after_stop_still_answers(self):
        pipe = vd.VerifyPipeline(depth=2, device=CPU, host_workers=1)
        pipe.start()
        pipe.stop()
        items = make_items(3, seed=9, bad=(1,))
        h = pipe.submit(items)
        assert h.result(timeout=5) == (False, oracle(items))
        assert h.path == "host"

    def test_backpressure_bounds_inflight(self):
        release = threading.Event()
        submitted = []

        def gated(win):
            release.wait(timeout=30)
            return True, [True] * len(win.items)

        with vd.VerifyPipeline(depth=2, device=CPU, host_workers=1,
                               dispatch_fn=gated) as pipe:
            def feeder():
                for w in range(4):
                    submitted.append(pipe.submit(make_items(2, seed=w),
                                                 device_threshold=1))

            th = threading.Thread(target=feeder, daemon=True)
            th.start()
            assert wait_until(lambda: len(submitted) == 2)
            assert not wait_until(lambda: len(submitted) > 2, timeout=0.1)
            assert pipe.inflight == 2
            release.set()
            th.join(timeout=30)
            assert [h.result(timeout=30)[0] for h in submitted] == \
                [True] * 4

    def test_entry_points_raise_without_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for make in (vd.VerifyPipeline, vd.default_pipeline):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
        assert vd.VerifyPipeline(device=CPU).device == torch.device(CPU)

    def test_device_hash_staging_and_its_host_hash_fallback(self,
                                                            monkeypatch):
        """COMETBFT_TPU_DEVICE_HASH=1 (read per submit): a window stages
        for the device-hash program, packed byte for byte as
        pack_rlc_device_hash packs it; a message over the block bucket
        re-stages through host hashing, counted and recorded."""
        rec = flightrec.FlightRecorder()
        flightrec.set_recorder(rec)
        seen = []

        def record(win):
            seen.append(win)
            return judge_staged(win) if win.mode == "ed" else \
                (True, [True] * len(win.items))

        items = make_items(4, seed=12)
        long = list(items)
        long[2] = (long[2][0], b"\x00" * 400, long[2][2])
        import secrets

        monkeypatch.setattr(secrets, "token_bytes",
                            lambda n: bytes(i % 251 for i in range(n)))
        try:
            monkeypatch.setenv("COMETBFT_TPU_DEVICE_HASH", "1")
            with vd.VerifyPipeline(depth=2, device=CPU, host_workers=1,
                                   dispatch_fn=record) as pipe:
                pipe.submit(items, device_threshold=1).result(timeout=30)
                pipe.submit(long, device_threshold=1).result(timeout=30)
            monkeypatch.setenv("COMETBFT_TPU_DEVICE_HASH", "0")
            assert not ted.device_hash_enabled()
        finally:
            flightrec.set_recorder(None)
        assert [w.mode for w in seen] == ["ed_hash", "ed"]
        cols = [list(c) for c in zip(*items)]
        want = ted.pack_rlc_device_hash(*cols)
        got = seen[0].packed
        assert len(got) == len(want)
        assert all((x == y).all() for x, y in zip(got, want))
        assert [e["kind"] for e in rec.events()].count(
            flightrec.EV_DEVICE_HASH_FALLBACK) == 1


# -- the drain, and what it records -----------------------------------------------

class TestPipelineDrain:
    def test_device_fault_drains_to_host_with_parity(self):
        fixtures = [make_items(6, seed=w, bad=((2,) if w == 1 else ()))
                    for w in range(3)]
        armed = [True]

        def flaky(win):
            if armed[0]:
                armed[0] = False
                raise RuntimeError("injected device failure")
            return judge_staged(win)

        rec = flightrec.FlightRecorder()
        flightrec.set_recorder(rec)
        reg = metrics.Registry("cometbft_tpu")
        metrics.set_device_metrics(metrics.DeviceMetrics(reg))
        try:
            with vd.VerifyPipeline(depth=3, device=CPU, host_workers=1,
                                   dispatch_fn=flaky) as pipe:
                handles = [pipe.submit(list(f), device_threshold=1)
                           for f in fixtures]
                results = [h.result(timeout=30) for h in handles]
                again = pipe.submit(make_items(4, seed=11),
                                    device_threshold=1)
                assert again.result(timeout=30)[0] is True
                assert again.path == "device"
        finally:
            flightrec.set_recorder(None)
            metrics.set_device_metrics(None)
        assert [v for _, v in results] == [oracle(f) for f in fixtures]
        assert handles[0].path == "drain" and pipe.faults == 1
        kinds = [e["kind"] for e in rec.events()]
        assert flightrec.EV_PIPELINE_DRAIN in kinds
        assert flightrec.EV_DEVICE_FALLBACK in kinds
        drain = next(e for e in rec.events()
                     if e["kind"] == flightrec.EV_PIPELINE_DRAIN)
        assert "inflight" in drain and "staged" in drain
        flush = next(e for e in rec.events()
                     if e["kind"] == flightrec.EV_VERIFY_FLUSH)
        assert "inflight" in flush and "staged" in flush
        text = reg.expose()
        assert "cometbft_tpu_device_pipeline_drains 1" in text
        assert "cometbft_tpu_device_pipeline_inflight_windows" in text

    @pytest.mark.parametrize("devices", [None, ["cpu:0", "cpu:1"]],
                             ids=["single", "mesh"])
    def test_kernel_build_error_fails_the_handle_and_drains_nothing(
            self, monkeypatch, tmp_path, devices):
        """A kernel library that cannot build (here: no nvcc) is not a
        device fault: the window's handle raises KernelBuildError, no
        window drains to the host, the device stays healthy, and the
        failed build is not retried in the same process."""
        from cometbft_tpu_torch.ops import _build

        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build, "_libs", {})
        monkeypatch.setattr(_build, "_failed", {})
        monkeypatch.delenv("CUDA_HOME", raising=False)
        monkeypatch.setattr(_build.shutil, "which", lambda _n: None)
        monkeypatch.setattr(_build, "Path", _NoCudaPath)
        builds = []
        real_build = _build.build
        monkeypatch.setattr(_build, "build",
                            lambda names: (builds.append(names),
                                           real_build(names)))
        armed = [True]

        def build_then_judge(win):
            if armed[0]:
                armed[0] = False
                _build.load("sha2_kernels")
            return judge_staged(win)

        health = _health()
        with vd.VerifyPipeline(depth=2, device=CPU, host_workers=1,
                               dispatch_fn=build_then_judge,
                               devices=devices, health=health) as pipe:
            bad = pipe.submit(make_items(4, seed=1), device_threshold=1)
            with pytest.raises(_build.KernelBuildError, match="nvcc"):
                bad.result(timeout=30)
            good = pipe.submit(make_items(4, seed=2), device_threshold=1)
            assert good.result(timeout=30)[0] is True
            assert good.path == "device"
        assert (pipe.faults, pipe.drained_windows, pipe.host_windows) == \
            (0, 0, 0)
        assert health.state("0") == "healthy"
        with pytest.raises(_build.KernelBuildError, match="nvcc"):
            _build.load("sha2_kernels")
        assert builds == [["sha2_kernels"]]

    def test_staging_exception_goes_to_the_host_recorded_and_counted(
            self, monkeypatch):
        """A staging exception sends its window to the host, as in the
        JAX package (same verdicts, path "host"), and leaves an
        EV_STAGING_FALLBACK event with the exception's type and repr
        and a count apart from the threshold-routed host windows."""
        fixture = make_items(6, seed=4, bad=(3,))

        def broken(*_a, **_k):
            raise ValueError("staging broke")

        monkeypatch.setattr(vd, "parse_and_hash_parallel", broken)
        monkeypatch.setattr(jvd, "parse_and_hash_parallel", broken)
        rec = flightrec.FlightRecorder()
        flightrec.set_recorder(rec)
        try:
            with vd.VerifyPipeline(depth=2, device=CPU, host_workers=1,
                                   dispatch_fn=judge_staged) as pipe:
                h = pipe.submit(list(fixture), device_threshold=1)
                ok, verdicts = h.result(timeout=30)
                small = pipe.submit(make_items(2, seed=5),
                                    device_threshold=8)
                small.result(timeout=30)
        finally:
            flightrec.set_recorder(None)
        with jvd.VerifyPipeline(depth=2, host_workers=1,
                                dispatch_fn=judge_staged) as jpipe:
            jh = jpipe.submit(list(fixture), device_threshold=1)
            assert jh.result(timeout=30) == (ok, verdicts)
        assert (h.path, small.path) == (jh.path, "host") == ("host",
                                                             "host")
        assert verdicts == oracle(fixture) and ok is False
        assert (pipe.staging_fallbacks, pipe.host_windows, pipe.faults,
                pipe.drained_windows) == (1, 1, 0, 0)
        ev = [e for e in rec.events()
              if e["kind"] == flightrec.EV_STAGING_FALLBACK]
        assert len(ev) == 1
        assert (ev[0]["error"], ev[0]["batch"]) == ("ValueError", 6)
        assert ev[0]["detail"] == repr(ValueError("staging broke"))

    def test_spans_land_under_the_submitters_subsystem(self):
        release, started = threading.Event(), threading.Event()

        def held(win):
            started.set()
            release.wait(timeout=10)
            return True, [True] * len(win.items)

        tr = trace.StageTracer()
        trace.set_tracer(tr)
        try:
            with vd.VerifyPipeline(depth=2, device=CPU, host_workers=1,
                                   dispatch_fn=held) as pipe:
                h1 = pipe.submit(make_items(4, seed=1),
                                 subsystem="blocksync", device_threshold=1)
                assert started.wait(timeout=10)
                with trace.span("blocksync", "collect", inflight=1):
                    h2 = pipe.submit(make_items(4, seed=2),
                                     subsystem="blocksync",
                                     device_threshold=1)
                release.set()
                h1.result(timeout=30)
                h2.result(timeout=30)
        finally:
            trace.set_tracer(None)
        snap = tr.snapshot()
        assert snap["blocksync.host_pack"]["count"] == 2
        assert snap["blocksync.device"]["count"] == 2
        assert tr.overlap_seconds("blocksync", "device", "collect") > 0


# -- verify_async against the serial verify() ---------------------------------------

N_VALS = 4
_PRIVS = [jed.PrivKey.generate(bytes([70 + i]) * 32) for i in range(N_VALS)]


def _commits(bad_height=None):
    """The same three commits (heights 5-7, four validators) in both
    packages, one signature corrupted at `bad_height`."""
    jvals = JValidatorSet([JValidator(p.pub_key(), 10) for p in _PRIVS])
    tvals = TValidatorSet([TValidator(ted.PubKey(p.pub_key().bytes()), 10)
                           for p in _PRIVS])
    by_addr = {p.pub_key().address(): p for p in _PRIVS}
    out = []
    for h in (5, 6, 7):
        bid = jblock.BlockID(bytes([h]) * 32,
                             jblock.PartSetHeader(1, b"\x0c" * 32))
        tbid = tblock.BlockID(bid.hash, tblock.PartSetHeader(
            1, b"\x0c" * 32))
        js, ts = [], []
        for i, v in enumerate(jvals.validators):
            t = JTimestamp(1_700_000_000 + h, 1000 * i)
            sig = by_addr[v.address].sign(jcanon.vote_sign_bytes(
                "async-chain", 2, h, 0, bid, t))
            if h == bad_height and i == 2:
                sig = sig[:6] + bytes([sig[6] ^ 1]) + sig[7:]
            js.append(jblock.CommitSig(jblock.BLOCK_ID_FLAG_COMMIT,
                                       v.address, t, sig))
            ts.append(tblock.CommitSig(tblock.BLOCK_ID_FLAG_COMMIT,
                                       v.address,
                                       TTimestamp(t.seconds, t.nanos), sig))
        out.append((h, jblock.Commit(h, 0, bid, js), bid,
                    tblock.Commit(h, 0, tbid, ts), tbid))
    return jvals, tvals, out


def _batches(bad_height=None):
    jvals, tvals, commits = _commits(bad_height)
    jb, tb = jval.DeferredSigBatch(), tval.DeferredSigBatch()
    for h, jc, bid, tc, tbid in commits:
        jval.verify_commit_light("async-chain", jvals, bid, h, jc,
                                 defer_to=jb)
        tval.verify_commit_light("async-chain", tvals, tbid, h, tc,
                                 defer_to=tb, device=CPU)
    return jb, tb


def _outcome(fn):
    try:
        fn()
    except Exception as e:                      # noqa: BLE001
        return type(e).__name__, str(e), getattr(e, "failed_ctx", None)
    return None


class TestDeferredVerifyAsync:
    @pytest.mark.parametrize("bad_height", [None, 6])
    def test_async_matches_serial_and_the_jax_package(self, bad_height):
        _, serial = _batches(bad_height)
        want = _outcome(lambda: serial.verify(device=CPU))
        jb, tb = _batches(bad_height)
        with vd.VerifyPipeline(depth=2, device=CPU, host_workers=1) as pipe, \
                jvd.VerifyPipeline(depth=2, host_workers=1) as jpipe:
            waiter = tb.verify_async(pipe, subsystem="blocksync")
            jwaiter = jb.verify_async(jpipe, subsystem="blocksync")
            got = _outcome(lambda: waiter.wait(timeout=30))
            jgot = _outcome(lambda: jwaiter.wait(timeout=30))
            assert waiter.failed_contexts(timeout=30) == \
                jwaiter.failed_contexts(timeout=30) == \
                (set() if bad_height is None else {bad_height})
        assert got == want == jgot
        assert waiter.done() and tb.count() == 0
        if bad_height is not None:
            assert got[0] == "ErrInvalidSignature" and got[2] == 6

    def test_empty_batch_resolves_without_a_pipeline(self):
        waiter = tval.DeferredSigBatch().verify_async(None)
        assert waiter.done() and waiter.wait() is None
        assert waiter.failed_contexts() == set()


# -- health: watchdog, flap, brownout, mesh ------------------------------------------

def _health(**kw):
    kw.setdefault("quarantine_after", 1)
    kw.setdefault("probe_backoff_s", 0.05)
    kw.setdefault("probe_backoff_max_s", 0.2)
    return devhealth.HealthRegistry(**kw)


class TestHealthWatchdog:
    def test_hung_dispatch_host_resolved_quarantined_then_probed_back(self):
        release = threading.Event()
        hung = [False]

        def hang_once(win):
            if not hung[0]:
                hung[0] = True
                release.wait(timeout=10)
                raise RuntimeError("released after abandonment")
            return judge_staged(win)

        health = _health()
        rec = flightrec.FlightRecorder()
        flightrec.set_recorder(rec)
        reg = metrics.Registry("cometbft_tpu")
        metrics.set_device_metrics(metrics.DeviceMetrics(reg))
        fixtures = [make_items(4, seed=w, bad=((1,) if w == 0 else ()))
                    for w in range(2)]
        try:
            with vd.VerifyPipeline(depth=3, device=CPU, host_workers=1,
                                   dispatch_fn=hang_once, health=health,
                                   dispatch_deadline_s=DEADLINE) as pipe:
                handles = [pipe.submit(list(f), device_threshold=1)
                           for f in fixtures]
                results = [h.result(timeout=30) for h in handles]
                assert handles[0].path == "drain"
                assert wait_until(lambda: health.usable("0"))
                again = pipe.submit(make_items(4, seed=9),
                                    device_threshold=1)
                assert again.result(timeout=30)[0] is True
                assert again.path == "device"
                release.set()
        finally:
            release.set()
            flightrec.set_recorder(None)
            metrics.set_device_metrics(None)
        assert [v for _, v in results] == [oracle(f) for f in fixtures]
        assert health.quarantines("0") == 1
        assert len(health.recovery_seconds("0")) == 1
        kinds = [e["kind"] for e in rec.events()]
        for kind in (flightrec.EV_WATCHDOG_TIMEOUT,
                     flightrec.EV_DEVICE_QUARANTINE,
                     flightrec.EV_DEVICE_PROBE):
            assert kind in kinds
        wd = next(e for e in rec.events()
                  if e["kind"] == flightrec.EV_WATCHDOG_TIMEOUT)
        assert wd["device"] == "0" and wd["waited_s"] >= DEADLINE
        assert 'cometbft_tpu_device_watchdog_timeouts_total{device="0"} 1' \
            in reg.expose()

    def test_probe_build_error_keeps_the_device_benched(self):
        """A probe whose kernels do not build fails (no caller waits on
        it): the flight recorder keeps the error, the device stays out
        of rotation."""
        from cometbft_tpu_torch.ops import _build

        armed = [True]

        def fault_then_no_build(win):
            if win.handle.subsystem == "probe":
                raise _build.KernelBuildError("nvcc not found")
            if armed[0]:
                armed[0] = False
                raise RuntimeError("injected device failure")
            return judge_staged(win)

        health = _health()
        rec = flightrec.FlightRecorder()
        flightrec.set_recorder(rec)
        try:
            with vd.VerifyPipeline(depth=2, device=CPU, host_workers=1,
                                   dispatch_fn=fault_then_no_build,
                                   health=health) as pipe:
                fixture = make_items(4, seed=6)
                h = pipe.submit(list(fixture), device_threshold=1)
                assert h.result(timeout=30) == (True, oracle(fixture))
                assert h.path == "drain"
                assert wait_until(lambda: any(
                    e.get("result") == "build_error" for e in rec.events()))
        finally:
            flightrec.set_recorder(None)
        ev = next(e for e in rec.events() if e.get("result") == "build_error")
        assert (ev["kind"], ev["device"], ev["error"]) == \
            (flightrec.EV_DEVICE_PROBE, "0", "KernelBuildError")
        assert health.state("0") in ("quarantined", "probing")
        assert not health.usable("0")

    def test_flap_quarantines_once_not_thrash(self):
        flap = [3]

        def flaky(win):
            if flap[0] > 0:
                flap[0] -= 1
                raise RuntimeError("chip flap")
            return judge_staged(win)

        health = _health()
        items = make_items(5, seed=21, bad=(2,))
        with vd.VerifyPipeline(depth=2, device=CPU, host_workers=1,
                               dispatch_fn=flaky, health=health) as pipe:
            ok, verdicts = pipe.submit(list(items), device_threshold=1) \
                .result(timeout=30)
            assert wait_until(lambda: health.usable("0"))
        assert verdicts == oracle(items) and not ok
        snap = health.snapshot()["0"]
        assert health.quarantines("0") == 1
        assert snap["probes_failed"] >= 1 and snap["probes_ok"] == 1
        assert snap["state"] == "healthy"

    def test_brownout_all_quarantined_still_answers_on_host(self):
        def dead(win):
            raise RuntimeError("dead chip")

        health = _health(probe_backoff_s=60.0)
        rec = flightrec.FlightRecorder()
        flightrec.set_recorder(rec)
        fixtures = [make_items(4, seed=w, bad=((3,) if w == 1 else ()))
                    for w in range(3)]
        try:
            with vd.VerifyPipeline(depth=2, device=CPU, host_workers=1,
                                   dispatch_fn=dead, health=health) as pipe:
                assert pipe.max_window() is None
                first = pipe.submit(list(fixtures[0]), device_threshold=1)
                assert first.result(timeout=30)[1] == oracle(fixtures[0])
                assert wait_until(pipe.in_brownout)
                assert pipe.max_window() == vd.BROWNOUT_MAX_WINDOW
                rest = [pipe.submit(list(f), device_threshold=1)
                        for f in fixtures[1:]]
                for f, h in zip(fixtures[1:], rest):
                    assert h.result(timeout=30)[1] == oracle(f)
                    assert h.path == "host"
        finally:
            flightrec.set_recorder(None)
        brown = [e for e in rec.events() if e["kind"] == flightrec.EV_BROWNOUT]
        assert brown and brown[0]["entered"] is True
        assert (vd.BROWNOUT_DEPTH, vd.BROWNOUT_MAX_WINDOW) == \
            (jvd.BROWNOUT_DEPTH, jvd.BROWNOUT_MAX_WINDOW)

    def test_mesh_quarantine_skips_a_device_and_recovers(self):
        flap = [2]

        def flaky_dev0(win):
            if win.device_index == 0 and flap[0] > 0:
                flap[0] -= 1
                raise RuntimeError("dev0 flap")
            return judge_staged(win)

        health = _health()
        fixtures = [make_items(4, seed=w, bad=((0,) if w == 2 else ()))
                    for w in range(4)]
        with vd.VerifyPipeline(depth=4, device=CPU, host_workers=1,
                               dispatch_fn=flaky_dev0,
                               devices=["cpu:0", "cpu:1"],
                               health=health) as pipe:
            handles = [pipe.submit(list(f), device_threshold=1)
                       for f in fixtures]
            results = [h.result(timeout=30) for h in handles]
            assert wait_until(lambda: health.usable("0"))
        assert [v for _, v in results] == [oracle(f) for f in fixtures]
        assert health.quarantines("0") == 1 and health.quarantines("1") == 0
        assert health.state("1") == "healthy"

    def test_each_dispatch_thread_runs_under_its_devices_context(
            self, monkeypatch):
        """Mesh dispatch threads (and a watchdog's replacement) make their
        own device current, and hand that device to _device_dispatch."""
        scopes, dispatched = [], []
        real_scope = vd._device_scope

        def scope(device):
            scopes.append((threading.current_thread().name, device))
            return real_scope(device)

        monkeypatch.setattr(vd, "_device_scope", scope)
        release = threading.Event()
        hung = [False]

        def dispatch(self, win, device=None):
            dispatched.append((threading.current_thread().name, device))
            if win.device_index == 1 and not hung[0]:
                hung[0] = True
                release.wait(timeout=10)
            return judge_staged(win)

        monkeypatch.setattr(vd.VerifyPipeline, "_device_dispatch", dispatch)
        devices = ["cpu:0", "cpu:1"]
        try:
            with vd.VerifyPipeline(depth=4, device=CPU, host_workers=1,
                                   devices=devices, health=_health(),
                                   dispatch_deadline_s=DEADLINE) as pipe:
                handles = [pipe.submit(make_items(2, seed=w),
                                       device_threshold=1)
                           for w in range(4)]
                for h in handles:
                    h.result(timeout=30)
                assert wait_until(lambda: pipe.health.usable("1"))
                release.set()
        finally:
            release.set()
        name = pipe._name
        for thread, device in dispatched:
            idx = int(thread.split("-device-")[1].split("-")[0])
            assert device == devices[idx]
        assert {t for t, _ in dispatched} >= {f"{name}-device-0",
                                              f"{name}-device-1",
                                              f"{name}-device-1-r1"}
        assert (f"{name}-device-1-r1", "cpu:1") in scopes
        with vd.VerifyPipeline(depth=2, device=CPU, host_workers=1,
                               dispatch_fn=judge_staged) as pipe:
            pipe.submit(make_items(2, seed=5), device_threshold=1) \
                .result(timeout=30)
        assert (f"{pipe._name}-device", torch.device(CPU)) in scopes


# -- mixed keys, and the verdict cache ------------------------------------------------

class TestMixedAndCache:
    def test_mixed_key_window_merges_in_order(self):
        """A window of ed25519 and secp256k1 keys goes through
        MixedBatchVerifier (its sub-batches below their thresholds run
        the host loops here) and merges in submission order, as the JAX
        package's pipeline does."""
        from cometbft_tpu.crypto import secp256k1 as jsk
        from cometbft_tpu_torch.crypto import secp256k1 as tsk

        eds = make_items(3, seed=13, bad=(1,))
        sps = []
        for i in range(2):
            priv = jsk.PrivKey.generate(bytes([21, i]) + b"\x03" * 30)
            m = b"secp-msg" + bytes([i])
            sig = priv.sign(m)
            if i == 1:
                sig = sig[:3] + bytes([sig[3] ^ 1]) + sig[4:]
            sps.append((priv.pub_key().bytes(), m, sig))
        port = [(ted.PubKey(eds[0][0]),) + eds[0][1:],
                (tsk.PubKey(sps[0][0]),) + sps[0][1:],
                (ted.PubKey(eds[1][0]),) + eds[1][1:],
                (tsk.PubKey(sps[1][0]),) + sps[1][1:],
                (ted.PubKey(eds[2][0]),) + eds[2][1:]]
        jitems = [(jed.PubKey(eds[0][0]),) + eds[0][1:],
                  (jsk.PubKey(sps[0][0]),) + sps[0][1:],
                  (jed.PubKey(eds[1][0]),) + eds[1][1:],
                  (jsk.PubKey(sps[1][0]),) + sps[1][1:],
                  (jed.PubKey(eds[2][0]),) + eds[2][1:]]
        with vd.VerifyPipeline(depth=2, device=CPU, host_workers=1) as pipe:
            h = pipe.submit(port, device_threshold=1)
            got = h.result(timeout=60)
            assert h.path == "device"
        bv = jcb.MixedBatchVerifier(provider="cpu")
        for it in jitems:
            bv.add(*it)
        assert got == bv.verify() == (False, [True, True, False, False,
                                               True])

    def test_cache_partition_and_merge(self):
        """Only misses stage and dispatch; cached verdicts merge back in
        place; a fully cached window resolves at submit."""
        items = make_items(6, seed=31, bad=(4,))
        want = oracle(items)
        sigcache.set_enabled(True)
        sigcache.insert_many(items[:3], want[:3])
        staged = []

        def record(win):
            staged.append(list(win.items))
            return judge_staged(win)

        with vd.VerifyPipeline(depth=2, device=CPU, host_workers=1,
                               dispatch_fn=record) as pipe:
            h = pipe.submit(list(items), device_threshold=1)
            assert h.result(timeout=30) == (False, want)
            again = pipe.submit(list(items), device_threshold=1)
            assert again.done() and again.path == "cache"
            assert again.result() == (False, want)
        assert staged == [items[3:]]
