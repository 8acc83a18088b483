"""The port's mesh-aware dispatch on the CPU: crypto/mesh.py, the
routing of crypto/batch._device_verify, rlc_verify(use_cache=) and the
routing variables the JAX package reads from the environment.

Device lists name "cpu" several times: each chunk runs its plain
versions in turn on the host.  Verdicts are held against the JAX
package on its 8-virtual-device mesh (tests/conftest.py) and against
the pure-Python oracle; routes are seen through spies on the programs.
The variables are read at import, so the port's modules are reloaded
under each setting (and once more after it), and the JAX package's
values come from private copies of its modules loaded under the same
setting, leaving its imported modules as they are."""

import gc
import importlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cometbft_tpu
from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import mesh as jmesh
from cometbft_tpu.ops import ed25519 as jdev
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import ed25519_ref as tref
from cometbft_tpu_torch.crypto import mesh
from cometbft_tpu_torch.crypto import sigcache as tsigcache
from cometbft_tpu_torch.ops import ed25519 as tdev
from cometbft_tpu_torch.ops import sharding
from cometbft_tpu_torch.types import validation as tval

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _frozen_heap():
    """After each test's own objects are collected, the heap is frozen
    for the next: the per-test gc.collect() of the leak checks walks only
    what one test made.  Unfrozen at the module's end."""
    yield
    gc.unfreeze()


@pytest.fixture(autouse=True)
def _freeze_heap():
    gc.freeze()


@pytest.fixture(autouse=True)
def _port_sigcache():
    """The port's signature-verdict cache is process-wide: a triple
    verified in one test (or another file on the same worker) would be a
    hit in the next and skip the program that test means to run.  Start
    and end every test with an empty cache in the default state."""
    tsigcache.reset()
    tsigcache.set_enabled(None)
    yield
    tsigcache.reset()
    tsigcache.set_enabled(None)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions run thousands of small torch ops; beside other
    busy test workers, OpenMP's threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _items(n, seed=42, bad=()):
    """n (pubkey, msg, sig) with distinct keys; indices in `bad` get a
    signature with one bit of R flipped."""
    out = []
    for i in range(n):
        priv = ted.PrivKey.generate(bytes([seed, i & 0xFF, i >> 8])
                                    + b"\x05" * 29)
        m = b"mesh-item" + i.to_bytes(4, "little")
        sig = priv.sign(m)
        if i in bad:
            sig = sig[:6] + bytes([sig[6] ^ 1]) + sig[7:]
        out.append((priv.pub_key().bytes(), m, sig))
    return out


def _parsed(items):
    pks = [i[0] for i in items]
    return pks, ted.parse_and_hash(pks, [i[1] for i in items],
                                   [i[2] for i in items])


@pytest.fixture(scope="module")
def sigs16():
    """16 signatures with index 7 bad, and the same 16 clean."""
    bad, good = _items(16, bad=(7,)), _items(16)
    return bad, _parsed(bad), _parsed(good)


# -- crypto/mesh.py ----------------------------------------------------------

@pytest.mark.parametrize("ndev", range(1, 10))
def test_split_spans_matches_jax(ndev):
    for n in range(0, 41):
        assert mesh.split_spans(n, ndev) == jmesh.split_spans(n, ndev)


def test_verify_batch_mesh_matches_jax_and_oracle(sigs16):
    """The batch axis over 8 "cpu" shards against the JAX package's
    verify_batch_mesh over its 8 devices: index 7 and only it."""
    items, (pks, parsed), _ = sigs16
    got = mesh.verify_batch_mesh(pks, parsed, devices=[CPU] * 8)
    jparsed = jed.parse_and_hash(pks, [i[1] for i in items],
                                 [i[2] for i in items])
    want = [bool(v) for v in jmesh.verify_batch_mesh(pks, jparsed)]
    assert got == want == [tref.verify(*it) for it in items]
    assert [i for i, v in enumerate(got) if not v] == [7]


def test_split_rlc_verify_chunk_verdicts(sigs16):
    """The answers of the JAX package's slow-tier split test: index 7
    lands in chunk 0 of [0, 8)."""
    _, (pks, parsed), (gpks, gparsed) = sigs16
    assert mesh.split_rlc_verify(pks, parsed, [CPU, CPU]) == [False, True]
    assert mesh.split_rlc_verify(gpks, gparsed, [CPU, CPU]) == [True, True]


def test_split_rlc_verify_launches_before_reading(sigs16, monkeypatch):
    """Every chunk's program is launched, each on its own device, before
    any verdict is read back; a structural reject returns None."""
    _, _, (gpks, gparsed) = sigs16
    events = []

    class Verdict:
        def __init__(self, i):
            self.i = i

        def __bool__(self):
            events.append(("read", self.i))
            return True

    def fake_async(packed, use_cache=None, device="cuda"):
        events.append(("launch", str(device)))
        return Verdict(len(events))

    monkeypatch.setattr(ted, "rlc_verify_async", fake_async)
    devs = [torch.device("cpu"), torch.device("cpu:0"), torch.device("cpu")]
    assert mesh.split_rlc_verify(gpks, gparsed, devs) == [True] * 3
    assert [e[0] for e in events] == ["launch"] * 3 + ["read"] * 3
    assert [e[1] for e in events[:3]] == ["cpu", "cpu:0", "cpu"]
    broken = list(gparsed)
    broken[12] = None
    assert mesh.split_rlc_verify(gpks, broken, devs[:2]) is None


def test_maybe_split_is_opt_in(sigs16, monkeypatch):
    """Without COMETBFT_TPU_MESH_DEVICES, below MIN_SPLIT or with one
    device the split declines; otherwise it gives the window's verdict."""
    _, (pks, parsed), (gpks, gparsed) = sigs16
    monkeypatch.delenv("COMETBFT_TPU_MESH_DEVICES", raising=False)
    assert mesh.maybe_split_verify(pks, parsed, min_split=4) is None
    monkeypatch.setattr(sharding, "device_count", lambda: 1)
    monkeypatch.setenv("COMETBFT_TPU_MESH_DEVICES", "0")
    assert mesh.maybe_split_verify(pks, parsed, min_split=4) is None
    monkeypatch.setattr(sharding, "mesh_device_list", lambda k: [CPU, CPU])
    assert mesh.maybe_split_verify(pks, parsed, min_split=1 << 30) is None
    assert mesh.maybe_split_verify(pks, parsed, min_split=4) is False
    assert mesh.maybe_split_verify(gpks, gparsed, min_split=4) is True


def test_placed_cached_a_keyed_to_its_device(sigs16, monkeypatch):
    """rlc_verify(use_cache=True, device=d) builds d's own entry, then
    hits it; an entry of another device is not used."""
    _, _, (gpks, gparsed) = sigs16
    packed = ted.pack_rlc(gpks, [b""] * 16, [b""] * 16, parsed=gparsed)
    cache = ted.ATableCache()
    monkeypatch.setattr(ted, "_A_TABLE_CACHE", cache)
    a_bytes = packed[0].tobytes()
    cache._entries[(a_bytes, "cuda:1")] = (None, 0)     # never read
    assert ted.rlc_verify(packed, use_cache=True, device=CPU)
    assert (cache.hits, cache.misses) == (0, 1)
    assert ted.rlc_verify(packed, use_cache=True, device=CPU)
    assert (cache.hits, cache.misses) == (1, 1)
    assert (a_bytes, "cpu") in cache._entries


# -- crypto/batch._device_verify ---------------------------------------------

@pytest.fixture
def route_spy(monkeypatch):
    """Mesh on over two "cpu" devices, MIN_SPLIT lowered; records the
    device of each RLC program and the width of each per-signature
    program."""
    calls = {"rlc": [], "persig": []}
    rlc_async, persig = ted.rlc_verify_async, tdev.verify_kernel

    def rlc_spy(packed, use_cache=None, device="cuda"):
        calls["rlc"].append(str(device))
        return rlc_async(packed, use_cache=use_cache, device=device)

    def persig_spy(*args):
        calls["persig"].append(int(args[0].shape[-1]))
        return persig(*args)

    monkeypatch.setattr(ted, "rlc_verify_async", rlc_spy)
    monkeypatch.setattr(tdev, "verify_kernel", persig_spy)
    monkeypatch.setattr(sharding, "mesh_device_list", lambda k: [CPU, CPU])
    monkeypatch.setattr(mesh, "MIN_SPLIT", 4)
    return calls


def test_unplaced_dispatch_splits_and_localizes_over_the_mesh(sigs16,
                                                              route_spy):
    items, (pks, parsed), _ = sigs16
    ok, verdicts = tbatch._device_verify(pks, parsed, torch.device("cuda"))
    assert route_spy == {"rlc": ["cpu", "cpu"], "persig": [8, 8]}
    assert not ok and verdicts == [tref.verify(*it) for it in items]


def test_placed_dispatch_never_splits(sigs16, route_spy):
    items, (pks, parsed), _ = sigs16
    ok, verdicts = tbatch._device_verify(pks, parsed, CPU)
    assert route_spy == {"rlc": ["cpu"], "persig": [16]}
    assert not ok and verdicts == [tref.verify(*it) for it in items]


def test_unplaced_split_accept_reads_no_per_signature(sigs16, route_spy):
    _, _, (gpks, gparsed) = sigs16
    assert tbatch._device_verify(gpks, gparsed, torch.device("cuda")) == \
        (True, [True] * 16)
    assert route_spy == {"rlc": ["cpu", "cpu"], "persig": []}


# -- rlc_verify(use_cache=) --------------------------------------------------

# (use_cache, COMETBFT_TPU_A_CACHE on) for five calls on one validator set
USE_CACHE_CALLS = [(None, True), (None, True), (True, True), (False, True),
                   (None, False)]


def test_use_cache_takes_the_reference_route(sigs16, monkeypatch):
    """The same sequence of calls takes the same program in both
    packages: True the cached-A program, False the whole one, None the
    cache policy (cached-A from the second sighting on), which
    USE_A_CACHE off turns off.  The programs are stubs on both sides."""
    _, _, (gpks, gparsed) = sigs16
    packed = ted.pack_rlc(gpks, [b""] * 16, [b""] * 16, parsed=gparsed)
    routes = {"port": [], "jax": []}
    for mod, tab_fn, whole, cached, side, table in (
            (tdev, "build_a_tables", "rlc_verify_kernel",
             "rlc_verify_kernel_cached_a", "port",
             lambda w: (torch.zeros(1), torch.tensor(True))),
            (jdev, "build_a_tables_device", "rlc_verify_device",
             "rlc_verify_device_cached_a", "jax",
             lambda w: (np.zeros(1), np.bool_(True)))):
        monkeypatch.setattr(mod, tab_fn, table)
        for name, route in ((whole, "whole"), (cached, "cached_a")):
            monkeypatch.setattr(
                mod, name, lambda *a, _s=side, _r=route:
                routes[_s].append(_r) or torch.tensor(True))
    for ed in (ted, jed):
        monkeypatch.setattr(ed, "_A_TABLE_CACHE", ed.ATableCache())
        monkeypatch.setattr(ed.ATableCache, "MIN_K", 1)
    for use_cache, on in USE_CACHE_CALLS:
        for ed in (ted, jed):
            monkeypatch.setattr(ed, "USE_A_CACHE", on)
        assert ted.rlc_verify(packed, use_cache=use_cache, device=CPU)
        assert jed.rlc_verify(packed, use_cache=use_cache)
    assert routes["port"] == routes["jax"] == \
        ["whole", "cached_a", "cached_a", "whole", "whole"]


# -- routing variables, by reload ------------------------------------------------

ROUTING_VARS = {
    "COMETBFT_TPU_BATCH_THRESHOLD": "3",
    "COMETBFT_TPU_DEFERRED_THRESHOLD": "300",
    "COMETBFT_TPU_A_CACHE": "0",
    "COMETBFT_TPU_A_CACHE_CAP": "3",
    "COMETBFT_TPU_A_CACHE_MIN_K": "16",
    "COMETBFT_TPU_A_CACHE_BYTES": "1048576",
    "COMETBFT_TPU_MESH_MIN_SPLIT": "64",
}


def _routing(ed, batch, validation, mesh_mod):
    return {"batch_threshold": batch.DEVICE_THRESHOLD,
            "deferred_threshold": validation.DeferredSigBatch.DEVICE_THRESHOLD,
            "use_a_cache": ed.USE_A_CACHE,
            "a_cache_cap": ed._A_TABLE_CACHE._cap,
            "a_cache_min_k": ed.ATableCache.MIN_K,
            "a_cache_bytes": (ed._A_TABLE_CACHE._max_bytes,
                              ed.ATableCache()._max_bytes),
            "mesh_min_split": mesh_mod.MIN_SPLIT}


def _jax_copy(monkeypatch, name):
    """A private copy of cometbft_tpu.<name>, run under the current
    environment; the imported module stays as it is."""
    path = Path(cometbft_tpu.__file__).parent / (name.replace(".", "/")
                                                 + ".py")
    full = f"cometbft_tpu.{name}_envcopy"
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, full, mod)
    spec.loader.exec_module(mod)
    return mod


def _reload_port():
    for mod in (ted, tbatch, tval, mesh):
        importlib.reload(mod)


def _port_objects():
    return [(mod, dict(vars(mod))) for mod in (ted, tbatch, tval, mesh)]


def _restore(saved):
    """A reload makes new classes and objects (PubKey, DeferredSigBatch,
    the A-table cache); modules that imported the first ones, and
    libs/tmjson's key registry, still hold those: put them back."""
    for mod, objects in saved:
        vars(mod).update(objects)


@pytest.mark.parametrize(
    "var,setting",
    [(v, s) for v in sorted(ROUTING_VARS) for s in ("unset", "set")]
    + [("COMETBFT_TPU_DEFERRED_THRESHOLD", "below_batch")])
def test_routing_variables_read_as_jax(monkeypatch, var, setting):
    """Each variable, unset or set, gives the JAX package's value under
    the same environment (the deferred threshold also set below the
    batch threshold, where it takes the larger)."""
    for v in ROUTING_VARS:
        monkeypatch.delenv(v, raising=False)
    if setting == "below_batch":
        monkeypatch.setenv(var, "2")
        monkeypatch.setenv("COMETBFT_TPU_BATCH_THRESHOLD", "5")
    elif setting == "set":
        monkeypatch.setenv(var, ROUTING_VARS[var])
    saved = _port_objects()
    try:
        _reload_port()
        port = _routing(ted, tbatch, tval, mesh)
        jcopies = {n: _jax_copy(monkeypatch, n)
                   for n in ("crypto.ed25519", "crypto.batch", "crypto.mesh")}
        monkeypatch.setattr(jbatch, "DEVICE_THRESHOLD",
                            jcopies["crypto.batch"].DEVICE_THRESHOLD)
        jval = _jax_copy(monkeypatch, "types.validation")
        jax_side = _routing(jcopies["crypto.ed25519"], jcopies["crypto.batch"],
                            jval, jcopies["crypto.mesh"])
    finally:
        monkeypatch.undo()
        _reload_port()
        _restore(saved)
    assert port == jax_side
    if setting == "unset":
        assert port == {"batch_threshold": 8, "deferred_threshold": 128,
                        "use_a_cache": True, "a_cache_cap": 8,
                        "a_cache_min_k": 64,
                        "a_cache_bytes": (128 << 20, 128 << 20),
                        "mesh_min_split": 256}
