"""The light-client serving plane in the port (lightserve/: planner,
coalescer, session, payload codec; simnet/lightfleet.py; the encoders of
rpc/serialize.py) against the JAX package on the CPU.

The chain is the JAX package's (test_torch_execution.build_chain: 12
blocks, 4 validators, a fifth joining at height 7), its block and state
databases copied key for key into the port's MemDB, so both packages
serve the same stored bytes.  Payload bytes are compared at every
height; the coalescers are fed the same request sequence on a manual
flusher and compared step by step; the fleet digest is compared with the
JAX package's run_fleet on the same seed.  The port runs on device="cpu"
through a VerifyPipeline(device="cpu", host_workers=1); one window runs
the plain RLC program (K1-K4) with the thresholds lowered."""

import ast
import copy
import dataclasses
import gc
import pathlib
import random
import threading
import time

import pytest
import torch

from cometbft_tpu.crypto import dispatch as jdispatch
from cometbft_tpu.lightserve import coalesce as jco
from cometbft_tpu.lightserve import codec as jcodec
from cometbft_tpu.lightserve import planner as jplanner
from cometbft_tpu.lightserve import session as jsession
from cometbft_tpu.simnet import lightfleet as jfleet
from cometbft_tpu.types import validation as jval
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import dispatch as tdispatch
from cometbft_tpu_torch.crypto import sigcache
from cometbft_tpu_torch.libs import flightrec
from cometbft_tpu_torch.libs import lockrank as plr
from cometbft_tpu_torch.libs import metrics as tmetrics
from cometbft_tpu_torch.lightserve import coalesce as tco
from cometbft_tpu_torch.lightserve import codec as tcodec
from cometbft_tpu_torch.lightserve import planner as tplanner
from cometbft_tpu_torch.lightserve import session as tsession
from cometbft_tpu_torch.ops import _build, cuda_decompress, cuda_msm
from cometbft_tpu_torch.rpc import serialize as tser
from cometbft_tpu_torch.simnet import lightfleet as tfleet
from cometbft_tpu_torch.store.blockstore import BlockStore
from cometbft_tpu_torch.store.kv import MemDB
from cometbft_tpu_torch.state.store import StateStore
from cometbft_tpu_torch.types import validation as tval
from test_torch_execution import CHAIN, JAX, N_BLOCKS, build_chain, chain_spec

TOP = N_BLOCKS
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    gc.unfreeze()


@pytest.fixture(autouse=True)
def _freeze_heap():
    gc.freeze()


@pytest.fixture(autouse=True)
def _checks():
    """Lock ranks in raise mode, the port's verdict cache empty, no
    thread left behind."""
    plr.enable("raise")
    baseline = set(threading.enumerate())
    sigcache.reset()
    yield
    sigcache.reset()
    sigcache.set_enabled(None)
    assert plr.violations() == []
    plr.disable()
    assert plr.leaked_threads(baseline, grace_s=2.0) == []


def _copy_db(jdb):
    db = MemDB()
    for k, v in jdb.iterate():
        db.set(k, v)
    return db


@pytest.fixture(scope="module")
def chain():
    """The JAX chain and the port's stores over copies of its databases."""
    j = build_chain(JAX, chain_spec())
    port = (BlockStore(_copy_db(j.block_db)), StateStore(_copy_db(j.state_db)))
    return j, port


@pytest.fixture
def pipe():
    with tdispatch.VerifyPipeline(device="cpu", host_workers=1) as p:
        yield p


@pytest.fixture
def jpipe():
    with jdispatch.VerifyPipeline(host_workers=1) as p:
        yield p


def _port_session(chain, pipe, **kw):
    bs, ss = chain[1]
    return tsession.LightServeSession(bs, ss, CHAIN, pipeline=pipe,
                                      device="cpu", **kw)


def _jax_session(chain, jpipe, **kw):
    j = chain[0]
    return jsession.LightServeSession(j.bstore, j.sstore, CHAIN,
                                      pipeline=jpipe, **kw)


# -- planner -------------------------------------------------------------------------

def _pairs(seed, n, top):
    rng = random.Random(seed)
    out = [(1, 2), (9, 10), (1, top), (3, 100), (97, 100), (1, 10_000),
           (5, 5), (7, 3)]
    for _ in range(n):
        a = rng.randint(1, top)
        out.append((a, rng.randint(1, 3 * top)))
    return out


@pytest.mark.parametrize("depth", [None, 1, 3, 64])
def test_skip_path_equal_jax(depth):
    kw = {} if depth is None else {"max_pivots": depth}
    for trusted, target in _pairs(depth or 0, 200, 5000):
        assert tplanner.skip_path(trusted, target, **kw) == \
            jplanner.skip_path(trusted, target, **kw)


def test_planner_plans_and_hot_heights_equal_jax():
    rng = random.Random(11)
    tp, jp = tplanner.TrustPathPlanner(), jplanner.TrustPathPlanner()
    for _ in range(300):
        trusted = rng.choice([1, 5, 9, 10, 11]) if rng.random() < 0.8 \
            else rng.randint(1, 11)
        assert tp.plan(trusted, 12) == jp.plan(trusted, 12)
    for n in (1, 3, 8):
        assert tp.hot_trust_heights(n) == jp.hot_trust_heights(n)
        assert tp.hot_heights(12, n) == jp.hot_heights(12, n)
    enc = {h: b"blob%d" % h for h in range(1, 13)}
    assert tp.prefetch(12, enc.get) == jp.prefetch(12, enc.get)
    assert tp.stats() == jp.stats()
    assert tplanner.DEFAULT_PLAN_DEPTH == jplanner.DEFAULT_PLAN_DEPTH
    assert tplanner.DEFAULT_PAYLOAD_CAPACITY == \
        jplanner.DEFAULT_PAYLOAD_CAPACITY


# -- payload codec -------------------------------------------------------------------

@pytest.mark.parametrize("h", range(1, TOP + 1))
def test_payload_bytes_equal_jax(chain, pipe, jpipe, h):
    """The port's payload at every height is the JAX encoder's, byte for
    byte, and each JSON encoder of rpc/serialize.py on its own."""
    from cometbft_tpu.rpc import serialize as jser

    ts = _port_session(chain, pipe, coalesce=False)
    js = _jax_session(chain, jpipe, coalesce=False)
    try:
        blob = ts.payload_bytes(h)
        assert blob == js.payload_bytes(h)
        j = chain[0]
        meta, commit = j.bstore.load_block_meta(h), js._commit_for(h)
        vals = j.sstore.load_validators(h)
        pmeta, pcommit = chain[1][0].load_block_meta(h), ts._commit_for(h)
        pvals = chain[1][1].load_validators(h)
        assert tser.header_json(pmeta.header) == jser.header_json(meta.header)
        assert tser.commit_json(pcommit) == jser.commit_json(commit)
        assert [tser.validator_json(v) for v in pvals.validators] == \
            [jser.validator_json(v) for v in vals.validators]
        assert tser.block_id_json(pmeta.block_id) == \
            jser.block_id_json(meta.block_id)
        assert tcodec.decode_payload(blob) == jcodec.decode_payload(blob)
    finally:
        ts.close()
        js.close()


def _tamper_blob(blob):
    bad = bytearray(blob)
    i = bad.index(b'"signature"') + 20
    bad[i] ^= 1
    return bytes(bad)


@pytest.mark.parametrize("h", [1, 7, TOP])
def test_verify_payload_round_trips(chain, pipe, h):
    """The client side over the wire bytes: the rebuilt commit and set
    equal the JAX codec's, verify_payload accepts the payload as the JAX
    package does and refuses a flipped signature byte, a wrong chain and
    a height mismatch with the JAX package's messages."""
    ts = _port_session(chain, pipe, coalesce=False)
    try:
        blob = ts.payload_bytes(h)
    finally:
        ts.close()
    doc = tcodec.decode_payload(blob)
    sh = doc["signed_header"]
    assert tcodec.commit_from_json(sh["commit"]).to_proto() == \
        jcodec.commit_from_json(sh["commit"]).to_proto()
    assert tcodec.validator_set_from_json(doc["validator_set"]).to_proto() \
        == jcodec.validator_set_from_json(doc["validator_set"]).to_proto()
    assert tcodec.verify_payload(CHAIN, blob, device="cpu") == \
        jcodec.verify_payload(CHAIN, blob)
    bad = _tamper_blob(blob)
    with pytest.raises(jval.CommitVerificationError) as je:
        jcodec.verify_payload(CHAIN, bad)
    with pytest.raises(tval.CommitVerificationError) as te:
        tcodec.verify_payload(CHAIN, bad, device="cpu")
    assert type(te.value).__name__ == type(je.value).__name__
    for fn in (tcodec.verify_payload, jcodec.verify_payload):
        kw = {"device": "cpu"} if fn is tcodec.verify_payload else {}
        with pytest.raises(Exception, match="payload chain"):
            fn("other-chain", blob, **kw)
    moved = blob.replace(b'"height":"%d"' % h, b'"height":"%d"' % (h + 40),
                         1)
    msgs = []
    for fn, kw in ((tcodec.verify_payload, {"device": "cpu"}),
                   (jcodec.verify_payload, {})):
        with pytest.raises(Exception, match="height mismatch") as e:
            fn(CHAIN, moved, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -- coalescer -------------------------------------------------------------------------

def _script():
    """A request sequence: (op, args) steps fed to both coalescers."""
    return [("acquire", [1, 2, 3, 4, 5, 6, 7, 8]), ("acquire", [9]),
            ("acquire", [6, 7, 10, 10]), ("flush_once", 4),
            ("cancel", 2), ("acquire", [10, 11]), ("acquire", [12]),
            ("cancel", 4), ("flush_once", 3), ("acquire", [5, 6, 13]),
            ("flush_now", None), ("acquire", [6]), ("acquire", [6, 14]),
            ("cancel", 6), ("flush_now", None), ("acquire", [1, 2]),
            ("cancel", 8), ("flush_now", None)]


def _drive(mod, fail):
    """Run _script on mod's coalescer (manual flusher); per step its
    stats, the verify batches so far and each ticket's outcome."""
    batches = []

    def verify(heights):
        batches.append(list(heights))
        return {h: (ValueError(f"height {h} forged") if h in fail else None)
                for h in heights}

    co = mod.RequestCoalescer(verify, start=False)
    tickets, trace = [], []
    for op, arg in _script():
        if op == "acquire":
            t = co.acquire(arg)
            tickets.append(t)
            rec = (list(t.futures), sorted(t.owned))
        elif op == "cancel":
            tickets[arg].cancel()
            rec = None
        elif op == "flush_once":
            co.max_batch = arg
            rec = co._flush_once()
        else:
            co.max_batch = mod.DEFAULT_MAX_BATCH
            rec = co.flush_now()
        trace.append((op, rec, co.stats(), [list(b) for b in batches]))
    outcomes = []
    for t in tickets:
        states = []
        for h, f in t.futures.items():
            if f.cancelled():
                states.append((h, "cancelled"))
            elif not f.done():
                states.append((h, "pending"))
            elif f.exception() is not None:
                states.append((h, str(f.exception())))
            else:
                states.append((h, "ok"))
        outcomes.append(states)
    co.close()
    return trace, outcomes


@pytest.mark.parametrize("fail", [(), (6,), (6, 10, 13)])
def test_coalescer_equal_jax_step_for_step(fail):
    """Dedupe (one shared future a height), round-robin drain, cancel
    (only heights the ticket alone held leave the queue) and blame (a
    failed height fails every claimant) on a manual flusher, step for
    step against the JAX RequestCoalescer fed the same sequence."""
    assert _drive(tco, set(fail)) == _drive(jco, set(fail))


def test_coalescer_knobs_are_constants():
    assert (tco.DEFAULT_WINDOW_MS, tco.DEFAULT_MAX_BATCH) == \
        (jco.DEFAULT_WINDOW_MS, jco.DEFAULT_MAX_BATCH) == (2.0, 512)
    co = tco.RequestCoalescer(lambda hs: {}, window_ms=7, max_batch=3,
                              start=False)
    assert (co.window_s, co.max_batch) == (0.007, 3)
    assert co._cv.name == "lightserve.cv"
    co.close()


def test_coalescer_background_flusher_and_close():
    """With the flusher thread: concurrent waiters resolve, close()
    joins the thread and a later acquire raises."""
    co = tco.RequestCoalescer(lambda hs: {h: None for h in hs},
                              window_ms=1)
    tickets = [co.acquire([h, h + 1]) for h in range(1, 6)]
    for t in tickets:
        t.wait(timeout=10)
    thread = co._thread
    co.close()
    assert not thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        co.acquire([99])


# -- session -------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(TOP, 3), (1, TOP + 500), (0, TOP),
                                  (-3, 5), (5, 5), (None, 0), (2, None)])
def test_session_ranges_equal_jax(chain, pipe, jpipe, args):
    """Bad ranges raise LightServeError with the JAX package's message;
    good ones resolve to the same (trusted, target)."""
    ts = _port_session(chain, pipe, coalesce=False)
    js = _jax_session(chain, jpipe, coalesce=False)
    try:
        out = []
        for s, err in ((ts, tsession.LightServeError),
                       (js, jsession.LightServeError)):
            try:
                out.append(("ok", s._resolve_heights(*args)))
            except err as e:
                out.append(("error", str(e)))
        assert out[0] == out[1]
    finally:
        ts.close()
        js.close()


def test_session_serves_status_and_sync_like_jax(chain, pipe, jpipe):
    ts = _port_session(chain, pipe, coalesce=False)
    js = _jax_session(chain, jpipe, coalesce=False)
    try:
        for trusted, target in ((1, TOP), (9, TOP), (3, 8)):
            assert ts.serve(trusted, target) == js.serve(trusted, target)
        assert ts.sync(2, TOP) == js.sync(2, TOP)
        assert ts.prefetch_hot(TOP) == js.prefetch_hot(TOP)
        assert ts.status() == js.status()
    finally:
        ts.close()
        js.close()
    with pytest.raises(tsession.LightServeError, match="closed"):
        ts.serve(1, TOP)


def _serve_in_one_flush(sess, calls, fn):
    """Run fn(*call) for each call in a thread of its own against a
    session on a manual flusher; once every request holds its ticket,
    one flush_now drains them all as one merged window."""
    co, acquired = sess.coalescer, []
    acquire = co.acquire

    def counted(heights):
        t = acquire(heights)
        acquired.append(t)
        return t
    co.acquire = counted
    threads = [threading.Thread(target=fn, args=c) for c in calls]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while len(acquired) < len(calls) and time.monotonic() < deadline:
        time.sleep(0.001)
    assert len(acquired) == len(calls)
    co.flush_now()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)


class _ForgingStore:
    """A read-only double of a BlockStore: every read is the store's,
    except the commit of `bad` (its first signature's last byte
    flipped)."""

    def __init__(self, store, bad):
        self._store, self.bad = store, bad

    def __getattr__(self, name):
        if name.startswith(("save", "prune", "delete")):
            raise AttributeError(f"read-only store: {name}")
        return getattr(self._store, name)

    def _forge(self, commit):
        commit = copy.deepcopy(commit)
        cs = commit.signatures[0]
        commit.signatures[0] = dataclasses.replace(
            cs, signature=cs.signature[:-1] + bytes([cs.signature[-1] ^ 1]))
        return commit

    def load_block_commit(self, h):
        c = self._store.load_block_commit(h)
        return self._forge(c) if h == self.bad and c is not None else c

    def load_seen_commit(self, h):
        c = self._store.load_seen_commit(h)
        return self._forge(c) if h == self.bad and c is not None else c


def test_forged_commit_blames_only_requests_needing_it(chain, pipe):
    """One forged commit in a merged flush fails exactly the requests
    whose paths hold its height, with ErrInvalidSignature; the others in
    the same window are served; the height counts one failed_heights
    and one EV_LIGHTSERVE_REJECT; the stores are not written."""
    bs, ss = chain[1]
    bad = tplanner.skip_path(1, TOP)[0]
    rec = flightrec.FlightRecorder()
    flightrec.set_recorder(rec)
    sess = tsession.LightServeSession(_ForgingStore(bs, bad), ss, CHAIN,
                                      pipeline=pipe, device="cpu",
                                      coalesce=True, start=False)
    reqs = {"crosses": (1, TOP), "also": (2, TOP), "clean": (TOP - 1, TOP),
            "short": (8, 10)}
    results = {}
    try:
        def ask(name, trusted, target):
            try:
                results[name] = sess.serve(trusted, target)
            except Exception as e:                      # noqa: BLE001
                results[name] = e
        _serve_in_one_flush(sess, [(n, *a) for n, a in reqs.items()], ask)
    finally:
        sess.close()
        flightrec.set_recorder(None)
    for name, (trusted, target) in reqs.items():
        if bad in tplanner.skip_path(trusted, target):
            assert isinstance(results[name], tval.ErrInvalidSignature), name
            assert str(results[name]) == \
                f"invalid signature in commit at height {bad}"
        else:
            path, blobs = results[name]
            assert path == tplanner.skip_path(trusted, target)
            assert len(blobs) == len(path)
    assert sess.failed_heights == 1
    assert [e["height"] for e in rec.events()
            if e["kind"] == flightrec.EV_LIGHTSERVE_REJECT] == [bad]
    assert bs.load_block_commit(bad).signatures[0].signature == \
        chain[0].bstore.load_block_commit(bad).signatures[0].signature


def test_coalesced_and_direct_serving_bit_identical(chain, pipe):
    """The same requests served coalesced and direct return identical
    payloads; the coalesced session spends fewer windows and
    signatures."""
    reqs = [(1, TOP), (2, TOP), (1, TOP - 1), (5, TOP), (TOP - 2, TOP),
            (3, 9)]
    off = _port_session(chain, pipe, coalesce=False)
    try:
        direct = [off.serve(t, g) for t, g in reqs]
    finally:
        off.close()
    on = _port_session(chain, pipe, coalesce=True, start=False)
    out = [None] * len(reqs)
    try:
        _serve_in_one_flush(on, [(i, *a) for i, a in enumerate(reqs)],
                            lambda i, t, g: out.__setitem__(i, on.serve(t, g)))
    finally:
        on.close()
    assert out == direct
    assert on.verify_windows < off.verify_windows
    assert on.verify_sigs < off.verify_sigs
    assert on.coalescer.stats()["coalesced"] > 0


def test_window_runs_the_plain_rlc_program(chain, pipe, monkeypatch):
    """With the thresholds at 2 a coalesced window goes through
    MixedBatchVerifier: one RLC program (K1 twice, K4 once) for the
    whole merged flush, whatever the number of requests."""
    monkeypatch.setattr(tval.DeferredSigBatch, "DEVICE_THRESHOLD", 2)
    monkeypatch.setattr(tbatch, "DEVICE_THRESHOLD", 2)
    calls = {"k1": 0, "k4": 0}
    k1, k4 = cuda_decompress.decompress_plain, cuda_msm.fold_verify_plain

    def c1(*a):
        calls["k1"] += 1
        return k1(*a)

    def c4(*a):
        calls["k4"] += 1
        return k4(*a)
    monkeypatch.setattr(cuda_decompress, "decompress_plain", c1)
    monkeypatch.setattr(cuda_msm, "fold_verify_plain", c4)
    sigcache.set_enabled(False)
    sess = _port_session(chain, pipe, coalesce=True, start=False)
    try:
        tickets = [sess.coalescer.acquire(tplanner.skip_path(t, TOP))
                   for t in (1, 2, 9)]
        assert sess.coalescer.flush_now() > 0
        for t in tickets:
            t.wait(timeout=30)
    finally:
        sess.close()
    assert sess.verify_windows == 1
    assert calls == {"k1": 2, "k4": 1}


def test_kernel_build_error_fails_the_window_and_blames_no_height(
        chain, pipe, monkeypatch):
    """A kernel that does not build is no height's fault: the window's
    requests fail with KernelBuildError, failed_heights stays 0 and no
    EV_LIGHTSERVE_REJECT is recorded."""
    monkeypatch.setattr(tval.DeferredSigBatch, "DEVICE_THRESHOLD", 2)
    monkeypatch.setattr(tbatch, "DEVICE_THRESHOLD", 2)

    def no_build(*a, **k):
        raise _build.KernelBuildError("nvcc not found")
    monkeypatch.setattr(tbatch, "_device_verify", no_build)
    monkeypatch.setattr(tbatch, "_device_verify_hash", no_build)
    sigcache.set_enabled(False)
    rec = flightrec.FlightRecorder()
    flightrec.set_recorder(rec)
    try:
        for coalesce in (False, True):
            sess = _port_session(chain, pipe, coalesce=coalesce)
            try:
                with pytest.raises(_build.KernelBuildError,
                                   match="nvcc not found"):
                    sess.serve(1, TOP)
            finally:
                sess.close()
            assert sess.failed_heights == 0
    finally:
        flightrec.set_recorder(None)
    assert not [e for e in rec.events()
                if e.get("kind") == flightrec.EV_LIGHTSERVE_REJECT]


def test_metrics_series(chain, pipe):
    reg = tmetrics.Registry()
    lm = tmetrics.LightServeMetrics(reg)
    tmetrics.set_lightserve_metrics(lm)
    try:
        sess = _port_session(chain, pipe, coalesce=True, window_ms=1)
        try:
            sess.serve(1, TOP)
            sess.serve(2, TOP)
        finally:
            sess.close()
    finally:
        tmetrics.set_lightserve_metrics(None)
    assert tmetrics.lightserve_metrics() is None
    def value(m):
        return m._values.get((), 0.0)
    assert value(lm.requests_total) == 2
    assert value(lm.headers_served_total) == sess.headers_served
    assert value(lm.verify_windows_total) == sess.verify_windows
    assert value(lm.verify_sigs_total) == sess.verify_sigs
    assert value(lm.inflight_heights) == 0


# -- fleet -----------------------------------------------------------------------------

def test_fleet_mix_equal_jax():
    for n, tip, seed in ((48, 12, 23), (1000, 193, 7), (5, 2, 1)):
        assert tfleet.fleet_mix(n, tip, seed) == jfleet.fleet_mix(n, tip, seed)


def test_fleet_ab_digest_equal_jax_run_fleet(chain, pipe, jpipe):
    """fleet_ab at 48 clients: every client served in both arms, the
    digests identical across arms and equal to the JAX package's
    run_fleet over its own session on the same seed; the ON arm fewer
    windows and signatures; sampled clients verify their bytes."""
    bs, ss = chain[1]
    rec = tfleet.fleet_ab(bs, ss, CHAIN, 48, 23, workers=4, device="cpu",
                          pipeline=pipe, sample_verify=0.1)
    js = _jax_session(chain, jpipe, coalesce=False)
    try:
        jrec = jfleet.run_fleet(js, 48, 23, workers=4)
    finally:
        js.close()
    off, on = rec["arms"]["off"], rec["arms"]["on"]
    assert rec["digest"] == off["digest"] == on["digest"] == jrec["digest"]
    assert off["clients"] == on["clients"] == jrec["clients"] == 48
    assert on["verify_windows"] < off["verify_windows"]
    assert on["verify_sigs"] < off["verify_sigs"]
    assert off["verified_clients"] == on["verified_clients"] > 0
    assert rec["light_clients_served_per_sec"] > 0
    assert rec["light_serve_p99_ms"] > 0


def test_fleet_ab_raises_on_a_forged_height(chain, pipe):
    bs, ss = chain[1]
    with pytest.raises(RuntimeError, match="had failures"):
        tfleet.fleet_ab(_ForgingStore(bs, TOP), ss, CHAIN, 6, 23,
                        workers=2, device="cpu", pipeline=pipe)


# -- device rules and imports ------------------------------------------------------

def test_entry_points_need_a_card_unless_told_cpu(chain):
    bs, ss = chain[1]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsession.LightServeSession(bs, ss, CHAIN)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfleet.fleet_ab(bs, ss, CHAIN, 4, 1)
    blob = tcodec.encode_payload(
        TOP, bs.load_block_meta(TOP).header, bs.load_seen_commit(TOP),
        ss.load_validators(TOP))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcodec.verify_payload(CHAIN, blob)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("sub", ["lightserve", "simnet", "rpc"])
def test_no_jax_imports(sub):
    files = sorted((ROOT / "cometbft_tpu_torch" / sub).glob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "cometbft_tpu", "cryptography"), \
                (f.name, name)
