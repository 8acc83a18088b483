"""The port's vote stream (crypto/votestream.py) on the CPU, case by case
against the JAX package's tests/test_votestream.py, and held against the
JAX package: the same seeded triples, hostile ones among them (a key of
31 bytes, a non-canonical y, s >= L, R off the curve, a flipped bit, a
wrong message), give the JAX stream's host verdicts through the port's
stream on a VerifyPipeline(device="cpu") window (the plain K1-K4, and
K1 + K14 for the reject), and the JAX VerifyPipeline's device verdicts
(computed in a spawned process while the other cases run); the QoS seal
advisory with an injected clock and a stub pipeline, so no bound reads
the wall clock; the pre-warm's window; a KernelBuildError that reaches
every vote future of its batch and never the host; and the device rule
(no card: StreamingVerifier() raises).  Flush intervals are at most
0.2 s, pools have one worker, and the port's lock ranks run in raise
mode."""

import gc
import multiprocessing
import threading
import time
from concurrent.futures import Future

import jax
import pytest
import torch

from cometbft_tpu.crypto import sigcache as jsigcache
from cometbft_tpu.crypto import votestream as jstream
from cometbft_tpu.types import validation as jval
from cometbft_tpu.types import vote as jvote
from cometbft_tpu.types import vote_set as jvs
from cometbft_tpu_torch.crypto import dispatch as vd
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.crypto import sigcache
from cometbft_tpu_torch.crypto import votestream as tstream
from cometbft_tpu_torch.libs import flightrec
from cometbft_tpu_torch.libs import lockrank as plr
from cometbft_tpu_torch.ops._build import KernelBuildError
from cometbft_tpu_torch.types import validation as tval
from cometbft_tpu_torch.types import vote as tvote
from cometbft_tpu_torch.types import vote_set as tvs
from tests import test_torch_vote_set as tv

CPU = "cpu"


def make_sig(i=0, msg=b"streaming-vote"):
    """The JAX package's fixture: one signed triple of key i."""
    priv = ted.PrivKey.generate(bytes([i + 1]) * 32)
    return priv.pub_key().bytes(), msg, priv.sign(msg)


def hostile_items():
    """Sixteen seeded votes: eight good ones under distinct keys, then a
    flipped signature bit, a key of 31 bytes, the identity key encoded
    with a non-canonical y (p + 1) and a signature valid for it under
    ZIP-215, s + L, R off the curve, a wrong message, a 65-byte
    signature and an exact duplicate of the first vote."""
    items = [make_sig(i, b"vote-%d" % i) for i in range(8)]
    pk, m, s = items[0]
    items.append((pk, m, s[:6] + bytes([s[6] ^ 1]) + s[7:]))
    items.append((items[1][0][:31], items[1][1], items[1][2]))
    r = 0x1234567
    big_r = ref.point_compress(ref.point_mul(r, ref.B))
    ident = (ref.P + 1).to_bytes(32, "little")
    items.append((ident, b"identity", big_r + r.to_bytes(32, "little")))
    pk, m, s = items[2]
    s_big = (int.from_bytes(s[32:], "little") + ref.L).to_bytes(32, "little")
    items.append((pk, m, s[:32] + s_big))
    off = next(y for y in range(2, 100)
               if ref.point_decompress(y.to_bytes(32, "little")) is None)
    pk, m, s = items[3]
    items.append((pk, m, off.to_bytes(32, "little") + s[32:]))
    pk, m, s = items[4]
    items.append((pk, m + b"!", s))
    pk, m, s = items[5]
    items.append((pk, m, s + b"\x00"))
    items.append(items[0])
    return items


def _jax_pipeline_verdicts(conn, items, config):
    """In the spawned process: the JAX VerifyPipeline's verdicts on the
    hostile window, on its device lane (the RLC program, then the
    per-signature kernel for the reject)."""
    try:
        for name, value in config.items():
            jax.config.update(name, value)
        from cometbft_tpu.crypto import dispatch as jvd

        jsigcache.set_enabled(False)
        with jvd.VerifyPipeline(depth=2, host_workers=1) as pipe:
            h = pipe.submit(list(items), subsystem="consensus",
                            device_threshold=2)
            ok, verdicts = h.result(timeout=1200)
            conn.send(("ok", (h.path, ok, verdicts)))
    except BaseException as e:              # noqa: BLE001
        conn.send(("error", repr(e)))
    finally:
        conn.close()


@pytest.fixture(scope="module", autouse=True)
def _jax_pipeline():
    """The JAX pipeline's window started in a child at the module's
    start (tens of seconds of XLA work), read by the last case."""
    config = {name: getattr(jax.config, name) for name in (
        "jax_platforms", "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_jax_pipeline_verdicts, daemon=True,
                       args=(send, hostile_items(), config))
    proc.start()
    send.close()
    yield recv
    if proc.is_alive():
        proc.terminate()
    proc.join(timeout=10)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _frozen_heap():
    """The heap frozen before each case (the per-test gc.collect() of the
    leak checks walks only what one case made); unfrozen at the end."""
    yield
    gc.unfreeze()


@pytest.fixture(autouse=True)
def _freeze_heap():
    gc.freeze()


@pytest.fixture(scope="module", autouse=True)
def _no_dropped_futures():
    """The port's future-leak registry armed: a vote future collected
    with an exception nobody read fails the module."""
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
    each case; both verdict caches empty and in their default state."""
    plr.enable("raise")
    baseline = set(threading.enumerate())
    sigcache.reset()
    sigcache.set_enabled(None)
    jsigcache.reset()
    jsigcache.set_enabled(None)
    yield
    sigcache.set_enabled(None)
    sigcache.reset()
    assert plr.violations() == []
    plr.disable()
    assert plr.leaked_threads(baseline, grace_s=1.0) == []


class _Handle:
    """A window handle of a stub pipeline: resolves with (ok, verdicts)
    or fails, then runs its callbacks, as WindowHandle does."""

    def __init__(self, path="device"):
        self._f = Future()
        self.path = path

    def result(self, timeout=None):
        return self._f.result(timeout)

    def add_done_callback(self, fn):
        self._f.add_done_callback(lambda _f: fn(self))


class _StubPipeline:
    """Captures submissions; each window resolves with `judge`'s verdicts
    (the port's ed25519_ref by default), fails with `fail`, or the submit
    raises `raise_at_submit`.  qos_seal_due answers `seal`, counting
    polls."""

    def __init__(self, judge=None, fail=None, raise_at_submit=None):
        self.windows = []
        self.judge = judge or (lambda items: [
            len(pk) == 32 and ref.verify(pk, m, s) for pk, m, s in items])
        self.fail = fail
        self.raise_at_submit = raise_at_submit
        self.seal = threading.Event()
        self.polls = []

    def submit(self, items, subsystem=None, device_threshold=None,
               ctx=None, lat=None):
        items = list(items)
        self.windows.append((items, subsystem, device_threshold))
        if self.raise_at_submit is not None:
            raise self.raise_at_submit
        h = _Handle("error" if self.fail is not None else "device")
        if self.fail is not None:
            h._f.set_exception(self.fail)
        else:
            v = self.judge(items)
            h._f.set_result((all(v), v))
        return h

    def qos_seal_due(self, consumer):
        self.polls.append(consumer)
        return self.seal.is_set()


def _stream(side, **kw):
    if side is jstream:
        kw.pop("device", None)
        kw.pop("clock", None)
        return jstream.StreamingVerifier(**kw)
    kw.setdefault("device", CPU)
    return tstream.StreamingVerifier(**kw)


def _wait(cond, seconds=10.0):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


# -- tests/test_votestream.py, case by case ----------------------------------

@pytest.mark.parametrize("side", [jstream, tstream], ids=["jax", "port"])
def test_good_and_bad(side):
    sv = _stream(side, flush_interval=0.002)
    sv.start()
    try:
        pk, msg, sig = make_sig()
        good = sv.submit(pk, msg, sig)
        bad = sv.submit(pk, b"other msg", sig)
        short = sv.submit(b"\x01" * 5, msg, sig)
        assert good.result(timeout=5) is True
        assert bad.result(timeout=5) is False
        assert short.result(timeout=5) is False
    finally:
        sv.stop()


def test_concurrent_submissions_batch():
    sv = _stream(tstream, flush_interval=0.05)
    sv.start()
    try:
        items = [make_sig(i) for i in range(12)]
        futs = []
        barrier = threading.Barrier(4)

        def submitter(chunk):
            barrier.wait()
            for pk, msg, sig in chunk:
                futs.append(sv.submit(pk, msg, sig))

        threads = [threading.Thread(target=submitter, args=(items[i::4],))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(f.result(timeout=10) for f in futs)
        # the 50 ms window must have coalesced them into few flushes
        assert sv.flushes <= 4, sv.flushes
        assert sv.verified == 12
        assert sv.path_votes["host"] == 12
    finally:
        sv.stop()


def test_device_threshold_routes_to_device(monkeypatch):
    sv = _stream(tstream, flush_interval=0.05, device_threshold=4)
    calls = []

    def fake_device(batch):
        calls.append(len(batch))
        for _, _, _, fut, _, _ in batch:
            fut.set_result(True)

    monkeypatch.setattr(sv, "_flush_device", fake_device)
    sv.start()
    try:
        items = [make_sig(i) for i in range(6)]
        futs = [sv.submit(*it) for it in items]
        assert all(f.result(timeout=5) for f in futs)
        assert calls and calls[0] >= 4
        assert sv.device_flushes == 0     # the real one counts
        assert sv.path_flushes["device"] == len(calls)
    finally:
        sv.stop()


def test_single_vote_device_flush():
    """A stream with device_threshold=1 sends a lone vote to the card:
    the pipeline gets it with threshold 1, not the host's route."""
    stub = _StubPipeline()
    sv = _stream(tstream, flush_interval=0.05, device_threshold=1,
                 pipeline=stub)
    sv.start()
    try:
        item = make_sig(3)
        assert sv.submit(*item).result(timeout=5) is True
    finally:
        sv.stop()
    assert stub.windows == [([item], "consensus", 1)]
    assert sv.path_flushes == {"device": 1} and sv.window_paths == {
        "device": 1}


@pytest.mark.parametrize("side", [jstream, tstream], ids=["jax", "port"])
def test_submit_after_stop_still_answers(side):
    sv = _stream(side)
    sv.start()
    sv.stop()
    pk, msg, sig = make_sig()
    assert sv.submit(pk, msg, sig).result(timeout=1) is True


def test_default_verifier_restarts():
    v1 = tstream.default_verifier(device=CPU)
    assert v1.is_running() and v1.device == torch.device("cpu")
    assert tstream.default_verifier(device=CPU) is v1
    v1.stop()
    v2 = tstream.default_verifier(device=CPU)
    try:
        assert v2.is_running() and v2 is not v1
        assert v2.warmed.is_set()        # no pre-warm on the CPU
    finally:
        v2.stop()


def test_prewarm_dispatches_dummy_batch():
    """warmup=True: start() dispatches one window of distinct keys, the
    JAX package's window triple for triple."""
    got = []
    for side in (jstream, tstream):
        stub = _StubPipeline()
        sv = _stream(side, device_threshold=16, pipeline=stub, warmup=True)
        sv.start()
        try:
            assert sv.warmed.wait(timeout=60)
        finally:
            sv.stop()
        assert len(stub.windows) == 1
        items, subsystem, thr = stub.windows[0]
        assert subsystem == "consensus" and thr == 2 and len(items) == 16
        assert len({pk for pk, _, _ in items}) == 16
        got.append(items)
    assert [(bytes(pk), m, s) for pk, m, s in got[0]] == got[1]
    assert sv.warm_error is None


def test_cpu_device_skips_warm_by_default():
    stub = _StubPipeline()
    sv = _stream(tstream, pipeline=stub)
    sv.start()
    try:
        assert sv.warmed.is_set()
        assert stub.windows == []
    finally:
        sv.stop()


def test_prewarm_constant_forces_warm(monkeypatch):
    """PREWARM (the JAX package's COMETBFT_TPU_VOTE_PREWARM) overrides
    the device rule; the constructor's warmup overrides both."""
    monkeypatch.setattr(tstream, "PREWARM", True)
    stub = _StubPipeline()
    sv = _stream(tstream, device_threshold=4, pipeline=stub)
    sv.start()
    try:
        assert sv.warmed.wait(timeout=60)
        assert len(stub.windows) == 1 and len(stub.windows[0][0]) == 4
    finally:
        sv.stop()
    monkeypatch.setattr(tstream, "PREWARM", False)
    for warmup, windows in ((None, 0), (True, 1)):
        stub = _StubPipeline()
        sv = _stream(tstream, device_threshold=4, pipeline=stub,
                     warmup=warmup)
        sv.start()
        try:
            assert sv.warmed.wait(timeout=60)
            assert len(stub.windows) == windows
        finally:
            sv.stop()


def test_warm_start_precedes_first_flush():
    stub = _StubPipeline()
    sv = _stream(tstream, flush_interval=0.002, device_threshold=2,
                 pipeline=stub, warmup=True)
    sv.start()
    try:
        assert sv.warmed.wait(timeout=60)
        a, b = make_sig(0), make_sig(1)
        fa, fb = sv.submit(*a), sv.submit(*b)
        assert fa.result(timeout=5) is True and fb.result(timeout=5) is True
        assert len(stub.windows[0][0]) == 2     # the pre-warm came first
    finally:
        sv.stop()


@pytest.mark.parametrize("side", [jstream, tstream], ids=["jax", "port"])
def test_exact_triple_match_only(side):
    pk, msg, sig = make_sig()
    sv = _stream(side, flush_interval=0.001)
    sv.start()
    try:
        fut = sv.submit(pk, msg, sig)
        fut.result(timeout=5)
        pv = side.Preverified(pk, msg, sig, fut)
        assert pv.verdict_for(pk, msg, sig) is True
        assert pv.verdict_for(pk, b"different", sig) is None
        assert pv.verdict_for(b"\x02" * 32, msg, sig) is None
    finally:
        sv.stop()


@pytest.mark.parametrize("side", [jstream, tstream], ids=["jax", "port"])
def test_pending_future_cancels_not_blocks(side):
    pk, msg, sig = make_sig()
    fut = Future()                   # never resolved
    pv = side.Preverified(pk, msg, sig, fut)
    assert pv.verdict_for(pk, msg, sig) is None
    assert fut.cancelled()           # dropped from the worker's batch


@pytest.mark.parametrize("bad_height", [6, 5])
def test_failed_ctx_attribution(bad_height):
    """A bad signature in a deferred batch raises naming the commit's
    context, with the JAX package's message (commits built by each
    package's VoteSet)."""
    import dataclasses

    got = []
    for side, val in ((tv.JAX, jval), (tv.PORT, tval)):
        vals, privs = tv.make_valset(side, 3)
        batch = val.DeferredSigBatch()
        commits = []
        for h in (5, 6, 7):
            vs = side.vs.VoteSet(tv.CHAIN, h, 0, side.vote.PRECOMMIT_TYPE,
                                 vals)
            bid = tv.block_id(side, h)
            for i, p in enumerate(privs):
                vs.add_vote(tv.signed_vote(side, p, i,
                                           side.vote.PRECOMMIT_TYPE, h, 0,
                                           bid))
            commits.append(vs.make_commit())
        bad = commits[bad_height - 5]
        bad.signatures = [dataclasses.replace(
            cs, signature=cs.signature[:6] + bytes([cs.signature[6] ^ 1])
            + cs.signature[7:]) for cs in bad.signatures]
        for h, commit in zip((5, 6, 7), commits):
            if side is tv.JAX:
                vals.verify_commit_light(tv.CHAIN, commit.block_id, h,
                                         commit, defer_to=batch)
            else:
                val.verify_commit_light(tv.CHAIN, vals, commit.block_id, h,
                                        commit, defer_to=batch, device=CPU)
        with pytest.raises(val.ErrInvalidSignature) as ei:
            if side is tv.JAX:
                batch.verify()
            else:
                batch.verify(device=CPU)
        got.append((ei.value.failed_ctx, str(ei.value)))
    assert got[0] == got[1] and got[1][0] == bad_height


# -- the QoS seal advisory, on an injected clock --------------------------------

@pytest.mark.parametrize("side", [jstream, tstream], ids=["jax", "port"])
def test_late_vote_seals_on_advisory(side):
    """A vote whose batch is forming waits out the flush interval until
    the pipeline's scheduler advises sealing: it seals then.  The port's
    clock is frozen, so only the advisory can flush it; the JAX
    package's interval (30 s) never runs out during the case."""
    stub = _StubPipeline()
    sv = _stream(side, flush_interval=30.0, device_threshold=10**9,
                 pipeline=stub, warmup=False, clock=lambda: 0.0)
    sv.start()
    try:
        pk, msg, sig = make_sig(0, msg=b"late-vote")
        fut = sv.submit(pk, msg, sig)
        assert _wait(lambda: len(stub.polls) >= 3)
        assert not fut.done() and sv.flushes == 0
        stub.seal.set()
        assert fut.result(timeout=10) is True
    finally:
        sv.stop()
    assert sv.verified == 1 and set(stub.polls) == {"consensus"}


def test_deadline_runs_on_the_injected_clock():
    """Without an advisory the batch flushes when the injected clock
    passes the oldest vote's deadline, and not before."""
    now = [100.0]
    stub = _StubPipeline()
    sv = _stream(tstream, flush_interval=5.0, device_threshold=10**9,
                 pipeline=stub, warmup=False, clock=lambda: now[0])
    sv.start()
    try:
        fut = sv.submit(*make_sig(0))
        assert _wait(lambda: len(stub.polls) >= 3)
        now[0] += 4.9
        n = len(stub.polls)
        assert _wait(lambda: len(stub.polls) >= n + 3)
        assert not fut.done()
        now[0] += 0.2
        assert fut.result(timeout=10) is True
    finally:
        sv.stop()


@pytest.mark.parametrize("side", ["jax", "port"])
def test_idle_or_stopped_pipeline_never_seals(side):
    from cometbft_tpu.crypto import dispatch as jvd

    mk = (lambda: jvd.VerifyPipeline(depth=4, name="OwnClassPipe",
                                     host_workers=1)) if side == "jax" \
        else (lambda: vd.VerifyPipeline(depth=4, name="OwnClassPipe",
                                        host_workers=1, device=CPU))
    with mk() as pipe:
        assert not pipe.qos_seal_due("consensus")      # idle queue
        h = pipe.submit([make_sig(0, msg=b"own-class")],
                        subsystem="consensus", device_threshold=10**9)
        h.result(timeout=30)
    assert not pipe.qos_seal_due("consensus")          # stopped


def test_seal_poll_under_both_locks():
    """_seal_due runs under votestream.cv (390) and takes the pipeline's
    dispatch.cv (400) when its queue holds work: legal in raise mode,
    and a blocksync window queued behind a held dispatch seals the
    vote's batch at once."""
    gate = threading.Event()

    def slow(win):
        gate.wait(timeout=10)
        v = [ref.verify(pk, m, s) for pk, m, s in win.items]
        return all(v), v

    with vd.VerifyPipeline(depth=4, host_workers=1, device=CPU,
                           dispatch_fn=slow) as pipe:
        first = pipe.submit([make_sig(1)], subsystem="blocksync",
                            device_threshold=1)
        queued = pipe.submit([make_sig(2)], subsystem="blocksync",
                             device_threshold=1)
        sv = tstream.StreamingVerifier(flush_interval=30.0,
                                       device_threshold=10**9,
                                       pipeline=pipe, device=CPU,
                                       clock=lambda: 0.0)
        sv.start()
        try:
            fut = sv.submit(*make_sig(0, msg=b"sealed"))
            assert fut.result(timeout=10) is True
        finally:
            sv.stop()
            gate.set()
        assert first.result(timeout=10)[0] and queued.result(timeout=10)[0]


# -- the port's own rules ------------------------------------------------------

def test_kernel_build_error_reaches_every_vote(monkeypatch):
    """A window whose kernels did not build: every vote future of the
    batch raises the KernelBuildError (a coalesced duplicate too), the
    flight recorder keeps it, Preverified re-raises it, and nothing is
    verified on the host.  Also when the submit itself raises it."""
    host = []
    monkeypatch.setattr(tstream, "_host_verify",
                        lambda *a: host.append(a) or True)
    rec = flightrec.FlightRecorder()
    flightrec.set_recorder(rec)
    try:
        for stub in (_StubPipeline(fail=KernelBuildError("no nvcc")),
                     _StubPipeline(raise_at_submit=KernelBuildError(
                         "no nvcc"))):
            sv = _stream(tstream, flush_interval=0.1, device_threshold=2,
                         pipeline=stub)
            sv.start()
            try:
                items = [make_sig(i) for i in range(3)]
                futs = [sv.submit(*it) for it in items]
                futs.append(sv.submit(*items[0]))
                for f in futs:
                    with pytest.raises(KernelBuildError):
                        f.result(timeout=10)
                pv = tstream.Preverified(*items[1], futs[1])
                with pytest.raises(KernelBuildError):
                    pv.verdict_for(*items[1])
            finally:
                sv.stop()
            assert sv.build_errors == 1 and sv.device_fallbacks == 0
            assert sv.coalesced == 1 and len(stub.windows) == 1
    finally:
        flightrec.set_recorder(None)
    assert host == []
    errs = [e for e in rec.events() if e["kind"] == flightrec.EV_VERIFY_FLUSH
            and e.get("path") == "error"]
    assert len(errs) == 2 and {e["error"] for e in errs} == {
        "KernelBuildError"}


def test_other_device_errors_take_the_recorded_host_route():
    """Any other exception, at submit or from the handle, routes the
    batch to the host as the JAX package does: right verdicts, counted in
    device_fallbacks, recorded as EV_DEVICE_FALLBACK."""
    sigcache.set_enabled(False)      # the second stub sees the same votes
    rec = flightrec.FlightRecorder()
    flightrec.set_recorder(rec)
    try:
        for stub in (_StubPipeline(fail=RuntimeError("device lost")),
                     _StubPipeline(raise_at_submit=RuntimeError("full"))):
            sv = _stream(tstream, flush_interval=0.1, device_threshold=2,
                         pipeline=stub)
            sv.start()
            try:
                pk, m, s = make_sig(0)
                futs = [sv.submit(pk, m, s), sv.submit(pk, m + b"!", s)]
                assert [f.result(timeout=10) for f in futs] == [True, False]
            finally:
                sv.stop()
            assert sv.device_fallbacks == 1 and sv.build_errors == 0
    finally:
        flightrec.set_recorder(None)
    assert len([e for e in rec.events()
                if e["kind"] == flightrec.EV_DEVICE_FALLBACK]) == 2


def test_prewarm_keeps_its_error():
    stub = _StubPipeline(fail=KernelBuildError("nvcc failed"))
    sv = _stream(tstream, device_threshold=4, pipeline=stub, warmup=True)
    sv.start()
    try:
        assert sv.warmed.wait(timeout=60)
        assert isinstance(sv.warm_error, KernelBuildError)
    finally:
        sv.stop()


def test_device_rule():
    """Without a card the default device raises; a pipeline on another
    device than the stream's raises; "cuda" matches any card."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstream.StreamingVerifier()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstream.default_verifier()
    stub = _StubPipeline()
    stub.device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="pipeline"):
        tstream.StreamingVerifier(device=CPU, pipeline=stub)
    assert tstream._same_device("cuda", "cuda:1")
    assert not tstream._same_device("cuda:0", "cuda:1")
    assert tstream._same_device("cpu", torch.device("cpu"))


def test_knobs_are_the_jax_packages_defaults():
    sv = tstream.StreamingVerifier(device=CPU)
    assert (sv.flush_interval, sv.device_threshold, sv.max_batch) == (
        jstream._FLUSH_INTERVAL, jstream._DEVICE_THRESHOLD,
        jstream._MAX_BATCH)
    assert tstream._SEAL_POLL_S == jstream._SEAL_POLL_S
    assert tstream.PREWARM is None


def test_vote_set_with_a_pending_preverification():
    """VoteSet cancels a pending preverification and verifies inline
    (verdict cache, then the host), as the JAX package does."""
    recs = []
    for side, vote_mod, vs_mod, stream in ((tv.JAX, jvote, jvs, jstream),
                                           (tv.PORT, tvote, tvs, tstream)):
        vals, privs = tv.make_valset(side, 3)
        vs = vs_mod.VoteSet(tv.CHAIN, 2, 0, vote_mod.PREVOTE_TYPE, vals)
        v = tv.signed_vote(side, privs[0], 0, vote_mod.PREVOTE_TYPE, 2, 0,
                           tv.block_id(side))
        fut = Future()
        v.preverified = stream.Preverified(
            vals.validators[0].pub_key.bytes(), v.sign_bytes(tv.CHAIN),
            v.signature, fut)
        recs.append((vs.add_vote(v), fut.cancelled(), v.preverified))
    assert recs[0] == recs[1] == (True, True, None)


# -- verdicts against the JAX package (keep last: reads the child) -----------

def test_hostile_verdicts_against_jax(_jax_pipeline):
    """The hostile window through the port's stream on a CPU pipeline
    (one window: the plain RLC program rejects, K1 + K14 localize) gives
    the JAX stream's host verdicts and the JAX pipeline's device
    verdicts."""
    items = hostile_items()
    jsv = jstream.StreamingVerifier(flush_interval=0.002, warmup=False)
    jsv.start()
    try:
        want = [f.result(timeout=30) for f in
                [jsv.submit(*it) for it in items]]
    finally:
        jsv.stop()
    oracle = [len(pk) == 32 and len(s) == 64 and ref.verify(pk, m, s)
              for pk, m, s in items]
    # the eight good votes, the duplicate, and the non-canonical identity
    # key, which ZIP-215 accepts
    assert want == oracle and want == [True] * 8 + [
        False, False, True, False, False, False, False, True]
    sigcache.set_enabled(False)
    with vd.VerifyPipeline(device=CPU, host_workers=1) as pipe:
        sv = tstream.StreamingVerifier(flush_interval=0.2,
                                       device_threshold=2, pipeline=pipe,
                                       device=CPU)
        sv.start()
        try:
            futs = [sv.submit(*it) for it in items]
            got = [f.result(timeout=120) for f in futs]
        finally:
            sv.stop()
    assert got == want
    assert sv.coalesced == 1 and sv.path_votes["host"] == 0
    assert sv.window_paths == {"device": sv.device_flushes}
    assert _jax_pipeline.poll(1200), "the JAX pipeline's child sent nothing"
    kind, value = _jax_pipeline.recv()
    assert kind == "ok", value
    path, ok, verdicts = value
    assert path == "device" and not ok and verdicts == want
