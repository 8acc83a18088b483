"""The port's light client (cometbft_tpu_torch/light/) against the JAX
package's on the CPU.  Chains come from tests/helpers.ChainBuilder (the
JAX package's types, 6 validators, 20 heights, two rotations: 3 of the
root's validators leave at height 8 and 2 more at 15, so one of the six
remains at 20 and skipping must bisect) and cross into the port as proto
bytes (convert.light_block_from_proto).  Each case runs on both packages
and compares the outcome exactly: the error class and message, the
bisection trace, the store's heights and bytes, the evidence bytes and
what each provider was sent.  The port runs on device="cpu"; its
sequential windows, and one commit check, are sent through the plain
RLC program (K1-K4) and the plain localization (K1 + K14) by lowering
the thresholds; the JAX package runs its host path
(COMETBFT_TPU_PROVIDER=cpu around its calls)."""

import ast
import contextlib
import copy
import dataclasses
import gc
import http.server
import json
import os
import pathlib
import threading
import types

import pytest
import torch

import helpers
from cometbft_tpu.light import client as jclient
from cometbft_tpu.light import provider as jprov
from cometbft_tpu.light import store as jstore
from cometbft_tpu.light import verifier as jver
from cometbft_tpu.types import validation as jval
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import sigcache
from cometbft_tpu_torch.libs import lockrank as plr
from cometbft_tpu_torch.light import client as tclient
from cometbft_tpu_torch.light import provider as tprov
from cometbft_tpu_torch.light import store as tstore
from cometbft_tpu_torch.light import types as tlight
from cometbft_tpu_torch.light import verifier as tver
from cometbft_tpu_torch.types import timestamp as tts
from cometbft_tpu_torch.types import validation as tval
from helpers import CHAIN_ID, ChainBuilder, gen_privkeys

CPU = "cpu"
SECOND = 1_000_000_000
TRUST = 24 * 3600 * SECOND
DRIFT = jver.DEFAULT_MAX_CLOCK_DRIFT
TOP = 20
FORK = 17
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "real_chain_commit.json")


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
def _caches():
    """The port's verdict cache empty and off (a cached triple would skip
    the plain programs), its lock ranks in raise mode, no thread left."""
    plr.enable("raise")
    baseline = set(threading.enumerate())
    sigcache.reset()
    sigcache.set_enabled(False)
    yield
    sigcache.reset()
    sigcache.set_enabled(None)
    assert plr.violations() == []
    plr.disable()
    assert plr.leaked_threads(baseline, grace_s=2.0) == []


@contextlib.contextmanager
def jax_host():
    """The JAX package's calls run its host verifiers."""
    prev = os.environ.get("COMETBFT_TPU_PROVIDER")
    os.environ["COMETBFT_TPU_PROVIDER"] = "cpu"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("COMETBFT_TPU_PROVIDER")
        else:
            os.environ["COMETBFT_TPU_PROVIDER"] = prev


@pytest.fixture
def device_windows(monkeypatch):
    """The port's deferred windows and commit checks of two signatures
    and more go to the plain programs."""
    monkeypatch.setattr(tval.DeferredSigBatch, "DEVICE_THRESHOLD", 2)
    monkeypatch.setattr(tbatch, "DEVICE_THRESHOLD", 2)


def _chain():
    privs0 = gen_privkeys(6)
    new1, new2 = gen_privkeys(3, salt=20), gen_privkeys(2, salt=40)
    b = ChainBuilder(privs=privs0)
    b.build(6)
    b.advance(next_privs=privs0[3:] + new1)
    b.build(6)
    b.advance(next_privs=[privs0[5]] + new1 + new2)
    b.build(FORK - 1 - b.height)
    fork = copy.deepcopy(b)
    b.build(TOP - b.height)
    return b, fork


@pytest.fixture(scope="module")
def chains():
    """The honest chain and a lunatic fork of it from FORK on (a forged
    app_hash, signed by the same keys), JAX blocks and port blocks."""
    honest, fork = _chain()
    orig = helpers.Header

    def forged(**kw):
        kw["app_hash"] = b"\xee" * 32
        return orig(**kw)

    helpers.Header = forged
    try:
        fork.build(TOP - fork.height)
    finally:
        helpers.Header = orig
    jb = {lb.height: lb for lb in honest.blocks}
    jf = {lb.height: lb for lb in fork.blocks}
    side = {}
    for name, blocks in (("jax", jb), ("jax_fork", jf)):
        side[name] = blocks
        side[name.replace("jax", "port")] = {
            h: convert.light_block_from_proto(lb) for h, lb in blocks.items()}
    for h in jb:
        assert side["port"][h].to_proto() == jb[h].to_proto()
    assert jf[FORK - 1].hash() == jb[FORK - 1].hash() != jf[FORK].hash()
    return side


def _jnow():
    return helpers.GENESIS_TIME.add_ns((TOP + 60) * SECOND)


def _tnow():
    t = _jnow()
    return tts.Timestamp(t.seconds, t.nanos)


JAX = types.SimpleNamespace(name="jax", ver=jver, client=jclient,
                            prov=jprov, store=jstore, val=jval, kw={},
                            now=_jnow, ctx=jax_host)
PORT = types.SimpleNamespace(name="port", ver=tver, client=tclient,
                             prov=tprov, store=tstore, val=tval,
                             kw={"device": CPU}, now=_tnow,
                             ctx=contextlib.nullcontext)
SIDES = (JAX, PORT)


def blocks_of(chains, side, fork=False):
    return chains[side.name + ("_fork" if fork else "")]


def outcome(fn):
    try:
        out = fn()
    except Exception as e:                       # noqa: BLE001
        return ("raise", type(e).__name__, str(e))
    return ("ok", out)


def on_both(chains, fn):
    """fn(side, blocks) on each package; the two outcomes."""
    got = []
    for side in SIDES:
        with side.ctx():
            got.append(outcome(lambda: fn(side, blocks_of(chains, side))))
    return got


def same(chains, fn, want=None):
    j, t = on_both(chains, fn)
    assert t == j
    if want is not None:
        assert j[:len(want)] == want
    return j


# -- the verifier ----------------------------------------------------------------

def _tamper(lb, idx):
    lb = copy.deepcopy(lb)
    c = lb.signed_header.commit
    s = c.signatures[idx]
    sig = bytearray(s.signature)
    sig[40] ^= 1
    c.signatures = list(c.signatures)
    c.signatures[idx] = dataclasses.replace(s, signature=bytes(sig))
    for memo in ("_hash", "_proto", "_sb_all"):
        if hasattr(c, memo):
            setattr(c, memo, None)
    return lb


VERIFIER_CASES = {
    "adjacent": (lambda s, b: s.ver.verify_adjacent(
        b[1].signed_header, b[2].signed_header, b[2].validator_set, TRUST,
        s.now(), DRIFT, **s.kw), ("ok",)),
    "non_adjacent": (lambda s, b: s.ver.verify_non_adjacent(
        b[1].signed_header, b[1].validator_set, b[6].signed_header,
        b[6].validator_set, TRUST, s.now(), DRIFT,
        s.ver.DEFAULT_TRUST_LEVEL, **s.kw), ("ok",)),
    "non_adjacent_across_rotation": (lambda s, b: s.ver.verify(
        b[1].signed_header, b[1].validator_set, b[11].signed_header,
        b[11].validator_set, TRUST, s.now(), DRIFT,
        s.ver.DEFAULT_TRUST_LEVEL, **s.kw), ("ok",)),
    "untrusted_rotation": (lambda s, b: s.ver.verify_light_block(
        b[1], b[TOP], TRUST, s.now(), DRIFT, s.ver.DEFAULT_TRUST_LEVEL,
        **s.kw), ("raise", "ErrNewValSetCantBeTrusted")),
    "backwards": (lambda s, b: s.ver.verify_backwards(
        b[4].header, b[5].header, **s.kw), ("ok",)),
    "backwards_gap": (lambda s, b: s.ver.verify_backwards(
        b[3].header, b[5].header, **s.kw), ("raise", "ErrInvalidHeader")),
    "expired": (lambda s, b: s.ver.verify_non_adjacent(
        b[1].signed_header, b[1].validator_set, b[6].signed_header,
        b[6].validator_set, TRUST, b[1].header.time.add_ns(2 * TRUST),
        DRIFT, s.ver.DEFAULT_TRUST_LEVEL, **s.kw),
        ("raise", "ErrOldHeaderExpired")),
    "not_adjacent": (lambda s, b: s.ver.verify_adjacent(
        b[1].signed_header, b[3].signed_header, b[3].validator_set, TRUST,
        s.now(), DRIFT, **s.kw), ("raise", "ErrHeaderHeightNotAdjacent")),
    "adjacent_as_skip": (lambda s, b: s.ver.verify_non_adjacent(
        b[1].signed_header, b[1].validator_set, b[2].signed_header,
        b[2].validator_set, TRUST, s.now(), DRIFT,
        s.ver.DEFAULT_TRUST_LEVEL, **s.kw),
        ("raise", "ErrHeaderHeightAdjacent")),
    "foreign_valset": (lambda s, b: s.ver.verify_non_adjacent(
        b[1].signed_header, b[1].validator_set, b[6].signed_header,
        b[TOP].validator_set, TRUST, s.now(), DRIFT,
        s.ver.DEFAULT_TRUST_LEVEL, **s.kw), ("raise", "ErrInvalidHeader")),
    "clock_drift": (lambda s, b: s.ver.verify_adjacent(
        b[1].signed_header, b[2].signed_header, b[2].validator_set, TRUST,
        b[2].header.time.add_ns(-DRIFT), DRIFT, **s.kw),
        ("raise", "ErrInvalidHeader")),
    "wrong_chain": (lambda s, b: s.ver.verify_adjacent(
        dataclasses.replace(b[1].signed_header, header=dataclasses.replace(
            b[1].header, chain_id="other")), b[2].signed_header,
        b[2].validator_set, TRUST, s.now(), DRIFT, **s.kw),
        ("raise", "ErrInvalidHeader")),
    "tampered_non_adjacent": (lambda s, b: s.ver.verify_non_adjacent(
        b[1].signed_header, b[1].validator_set,
        _tamper(b[6], 1).signed_header, b[6].validator_set, TRUST,
        s.now(), DRIFT, s.ver.DEFAULT_TRUST_LEVEL, **s.kw),
        ("raise", "ErrInvalidSignature")),
}


@pytest.mark.parametrize("case", sorted(VERIFIER_CASES))
def test_verifier_outcomes(chains, case):
    fn, want = VERIFIER_CASES[case]
    same(chains, fn, want)


def test_verifier_tampered_on_the_plain_programs(chains, device_windows):
    """The port's commit check of the adjacent header on the plain RLC
    program, its reject localized by the plain K1 + K14: the JAX
    package's error, wrapped in ErrInvalidHeader."""
    def fn(s, b):
        bad = _tamper(b[3], 2)
        s.ver.verify_adjacent(b[2].signed_header, bad.signed_header,
                              bad.validator_set, TRUST, s.now(), DRIFT,
                              **s.kw)
    got = same(chains, fn, ("raise", "ErrInvalidHeader"))
    assert "wrong signature (#2)" in got[2]


def test_trust_levels():
    for lvl in ((1, 3), (1, 1), (2, 3), (1, 4), (2, 1), (0, 1), (1, 0)):
        got = [outcome(lambda: s.ver.validate_trust_level(
            s.val.Fraction(*lvl))) for s in SIDES]
        assert got[1] == got[0], lvl


def test_all_signatures_past_two_thirds(chains):
    """A bad signature after the +2/3 (and the 1/3) early exit: the light
    checks pass, their _all_signatures forms name it, as in the JAX
    package."""
    def run(name, *extra):
        def fn(s, b):
            bad = _tamper(b[4], 5)
            c = bad.signed_header.commit
            vals = bad.validator_set
            f = getattr(s.val, name)
            if "trusting" in name:
                return f(CHAIN_ID, vals, c, s.val.Fraction(1, 3), **s.kw)
            return f(CHAIN_ID, vals, c.block_id, 4, c, **s.kw)
        return fn
    same(chains, run("verify_commit_light"), ("ok",))
    same(chains, run("verify_commit_light_trusting"), ("ok",))
    got = same(chains, run("verify_commit_light_all_signatures"),
               ("raise", "ErrInvalidSignature"))
    assert got[2].startswith("wrong signature (#5)")
    same(chains, run("verify_commit_light_trusting_all_signatures"),
         ("raise", "ErrInvalidSignature"))


# -- the client -----------------------------------------------------------------

def _client(side, blocks, primary=None, root=1, **kw):
    primary = primary or side.prov.MemoryProvider(CHAIN_ID, dict(blocks))
    return side.client.Client(
        CHAIN_ID, side.client.TrustOptions(TRUST, root, blocks[root].hash()),
        primary=primary, now_fn=side.now, **side.kw, **kw)


def _store(c):
    s = c.store
    return [(h, s.light_block(h).to_proto()) for h in range(1, TOP + 1)
            if s.light_block(h) is not None]


@pytest.mark.parametrize("depth", [1, 2])
def test_sequential_windows(chains, device_windows, depth):
    """Sequential sync 1 -> 20 in windows of 6 headers (four windows),
    serial and on a VerifyPipeline(device="cpu"): every window through
    the plain RLC program, the store the JAX client's."""
    calls = []
    verify = tval.DeferredSigBatch.verify
    verify_async = tval.DeferredSigBatch.verify_async

    def count(name, fn):
        def wrapped(self, *a, **k):
            calls.append((name, self.count()))
            return fn(self, *a, **k)
        return wrapped

    stores = []
    for side in SIDES:
        with side.ctx():
            c = _client(side, blocks_of(chains, side),
                        verification_mode=side.client.SEQUENTIAL,
                        sequential_batch_size=6, pipeline_depth=depth)
            if side is PORT:
                tval.DeferredSigBatch.verify = count("verify", verify)
                tval.DeferredSigBatch.verify_async = count("async",
                                                          verify_async)
            try:
                lb = c.verify_light_block_at_height(TOP)
            finally:
                tval.DeferredSigBatch.verify = verify
                tval.DeferredSigBatch.verify_async = verify_async
            assert lb.height == TOP
            stores.append(_store(c))
    assert stores[1] == stores[0]
    assert [h for h, _ in stores[1]] == list(range(1, TOP + 1))
    assert [n for _, n in calls] == [6 * 5, 6 * 5, 6 * 5, 5]
    assert {k for k, _ in calls} == {"verify" if depth == 1 else "async"}


def test_skipping_trace(chains):
    traces = []
    for side in SIDES:
        with side.ctx():
            c = _client(side, blocks_of(chains, side))
            inner = c._verify_skipping

            def rec(*a, _inner=inner):
                out = _inner(*a)
                traces.append([lb.height for lb in out])
                return out
            c._verify_skipping = rec
            c.verify_light_block_at_height(TOP)
            traces.append(_store(c))
    assert traces[0] == traces[2] == [1, 11, TOP]
    assert traces[3] == traces[1]


def test_backwards_without_signatures(chains, monkeypatch):
    stores = []
    for side in SIDES:
        with side.ctx():
            c = _client(side, blocks_of(chains, side), root=12)
            if side is PORT:
                def refuse(*a, **k):
                    raise AssertionError("a batch verify in backwards sync")
                monkeypatch.setattr(tval, "_verify", refuse)
                monkeypatch.setattr(tval.DeferredSigBatch, "verify", refuse)
            lb = c.verify_light_block_at_height(3)
            assert lb.height == 3
            stores.append(_store(c))
    assert stores[1] == stores[0]
    assert [h for h, _ in stores[0]] == [3, 12]


@pytest.mark.parametrize("depth", [1, 2])
def test_tampered_window(chains, device_windows, depth):
    """A tampered signature at height 9: the JAX client's error (class,
    message, failed height) and store, the port's window localized on the
    plain K1 + K14."""
    got, stores = [], []
    for side in SIDES:
        blocks = dict(blocks_of(chains, side))
        blocks[9] = _tamper(blocks[9], 3)
        with side.ctx():
            c = _client(side, blocks, verification_mode=side.client.SEQUENTIAL,
                        sequential_batch_size=8, pipeline_depth=depth)
            try:
                c.verify_light_block_at_height(TOP)
                got.append(None)
            except Exception as e:               # noqa: BLE001
                got.append((type(e).__name__, str(e),
                            getattr(e, "failed_ctx", None)))
            stores.append(_store(c))
    assert got[1] == got[0]
    assert got[0][0] == "ErrInvalidSignature" and got[0][2] == 9
    assert stores[1] == stores[0]
    assert [h for h, _ in stores[0]] == [1]


def test_lying_witness(chains):
    """A witness serving the lunatic fork: ErrLightClientAttack in both
    packages with the same evidence bytes, each provider sent the other
    side's evidence."""
    seen = []
    for side in SIDES:
        honest, forked = blocks_of(chains, side), blocks_of(chains, side, True)
        primary = side.prov.MemoryProvider(CHAIN_ID, dict(honest))
        witness = side.prov.MemoryProvider(CHAIN_ID,
                                           {**honest, **forked})
        with side.ctx():
            c = _client(side, honest, primary=primary, witnesses=[witness],
                        verification_mode=side.client.SEQUENTIAL,
                        sequential_batch_size=64, pipeline_depth=1)
            with pytest.raises(side.client.ErrLightClientAttack) as exc:
                c.verify_light_block_at_height(TOP)
        ev = exc.value.evidence
        assert str(exc.value) == "light client attack detected"
        seen.append((ev.to_proto(), ev.hash(), ev.common_height,
                     [e.to_proto() for e in primary.reported_evidence],
                     [e.to_proto() for e in witness.reported_evidence],
                     _store(c)))
    assert seen[1] == seen[0]
    ev_bytes, _, common, to_primary, to_witness, store = seen[0]
    assert common == FORK - 1
    assert to_witness == [ev_bytes] and len(to_primary) == 1
    assert to_primary[0] != ev_bytes
    assert [h for h, _ in store] == [1]


def test_primary_failover(chains):
    stores = []
    for side in SIDES:
        blocks = blocks_of(chains, side)
        dead = side.prov.MemoryProvider(CHAIN_ID)
        good = side.prov.MemoryProvider(CHAIN_ID, dict(blocks))
        with side.ctx():
            c = _client(side, blocks, primary=dead, witnesses=[good])
            assert c.primary is good and c.witnesses == [dead]
            c.verify_light_block_at_height(8)
        stores.append(_store(c))
    assert stores[1] == stores[0]


def test_file_store_bytes_and_prune(chains, tmp_path):
    dirs = {}
    for side in SIDES:
        d = tmp_path / side.name
        with side.ctx():
            c = _client(side, blocks_of(chains, side),
                        trusted_store=side.store.FileStore(str(d)),
                        verification_mode=side.client.SEQUENTIAL,
                        sequential_batch_size=64, pipeline_depth=1,
                        pruning_size=7)
            c.verify_light_block_at_height(TOP)
        dirs[side.name] = d

    def files(d):
        return {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert files(dirs["port"]) == files(dirs["jax"])
    assert len(files(dirs["jax"])) == 7
    stores = [s.store.FileStore(str(dirs[s.name])) for s in SIDES]
    for op in (lambda s: s.prune(4), lambda s: s.delete_light_blocks_before(
            TOP - 1), lambda s: s.prune(0)):
        got = [op(s) for s in stores]
        assert got[1] == got[0]
        assert files(dirs["port"]) == files(dirs["jax"])
        assert stores[1].size() == stores[0].size()
    # a port store reads the JAX store's files
    jst = jstore.FileStore(str(tmp_path / "j2"))
    for lb in blocks_of(chains, JAX).values():
        jst.save_light_block(lb)
    tst = tstore.FileStore(str(tmp_path / "j2"))
    assert tst.latest_light_block().to_proto() == \
        jst.latest_light_block().to_proto()
    assert tst.light_block_before(10).height == 9
    assert tst.first_light_block().height == 1
    ms = tstore.MemoryStore()
    for lb in blocks_of(chains, PORT).values():
        ms.save_light_block(lb)
    ms.prune(3)
    assert ms.size() == 3 and ms.first_light_block().height == TOP - 2


class _Fixture(http.server.BaseHTTPRequestHandler):
    """/commit and /validators from the recorded fixture; records every
    path it was asked."""

    fx: dict = {}
    asked: list = []

    def do_GET(self):
        self.asked.append(self.path)
        route = self.path.split("?")[0].strip("/")
        body = {"commit": self.fx["commit_response"],
                "validators": self.fx["validators_response"],
                "broadcast_evidence": {"result": {}}}.get(
            route, {"error": {"code": -32601, "message": "not found"}})
        raw = json.dumps(body).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def log_message(self, *a):
        pass


def test_http_provider_on_loopback(chains):
    with open(FIXTURE) as f:
        _Fixture.fx = json.load(f)
    _Fixture.asked = []
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Fixture)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        jp = jprov.HttpProvider("pin-chain-1", url)
        tp = tprov.HttpProvider("pin-chain-1", url, device=CPU)
        jlb, tlb = jp.light_block(12), tp.light_block(12)
        assert tlb.to_proto() == jlb.to_proto()
        assert tlb.hash().hex().upper() == \
            "43D14604A8621DBD99EC550B4E59B61F9DE9F86F3500F730764B79F6C750AEFB"
        jasked = list(_Fixture.asked)
        assert len(jasked) == 4
        assert jasked[:2] == jasked[2:]
        # evidence goes to /broadcast_evidence, the same query both ways
        ev = tclient.ErrLightClientAttack  # noqa: F841 (import check)
        from cometbft_tpu.types import evidence as jev
        from cometbft_tpu_torch.types import evidence as tev
        jl = chains["jax"][5]
        je = jev.LightClientAttackEvidence(jl, 4, [], 60, jl.header.time)
        te = tev.LightClientAttackEvidence(
            chains["port"][5], 4, [], 60, chains["port"][5].header.time)
        _Fixture.asked = []
        jp.report_evidence(je)
        tp.report_evidence(te)
        assert _Fixture.asked[0] == _Fixture.asked[1]
        assert _Fixture.asked[0].startswith("/broadcast_evidence?evidence=")
        # a failed request is ErrNoResponse in both
        dead = "http://127.0.0.1:9/"
        got = [outcome(lambda: p.light_block(3)) for p in (
            jprov.HttpProvider("c", dead, timeout=1.0),
            tprov.HttpProvider("c", dead, timeout=1.0, device=CPU))]
        assert got[0][:2] == got[1][:2] == ("raise", "ErrNoResponse")
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=5)


# -- entry points ---------------------------------------------------------------

def test_entry_points_need_a_card(chains):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    b = chains["port"]
    prov = tprov.MemoryProvider(CHAIN_ID, dict(b))
    for fn in (
            lambda: tclient.Client(CHAIN_ID, tclient.TrustOptions(
                TRUST, 1, b[1].hash()), primary=prov),
            lambda: b[2].validate_basic(CHAIN_ID),
            lambda: tver.verify_adjacent(
                b[1].signed_header, b[2].signed_header, b[2].validator_set,
                TRUST, _tnow(), DRIFT),
            lambda: tver.verify_backwards(b[1].header, b[2].header),
            lambda: tprov.HttpProvider(CHAIN_ID, "http://127.0.0.1:9")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    b[2].validate_basic(CHAIN_ID, device=CPU)


def test_light_modules_import_neither_jax_nor_the_jax_package():
    root = pathlib.Path(tlight.__file__).resolve().parent
    for path in sorted(root.glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "cometbft_tpu"), \
                    f"{path.name} imports {n}"


def test_prefetcher_bounded_close_on_a_wedged_fetch():
    import time

    release, entered = threading.Event(), threading.Event()

    def wedged():
        entered.set()
        release.wait(10.0)
        raise tprov.ErrLightBlockNotFound("provider died mid-fetch")

    ex = tclient._WindowPrefetcher()
    try:
        fut = ex.submit(wedged)
        assert entered.wait(5.0)
        t0 = time.perf_counter()
        ex.close(timeout=0.2)
        assert time.perf_counter() - t0 < 2.0
        assert ex._thread.daemon
    finally:
        release.set()
    ex._thread.join(timeout=5.0)
    assert not ex._thread.is_alive()
    with pytest.raises(tprov.ErrLightBlockNotFound):
        fut.result(timeout=5.0)
