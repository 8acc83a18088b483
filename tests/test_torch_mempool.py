"""The port's CListMempool and tx cache (mempool/) against the JAX
package's, on the CPU, over each package's kvstore app and LocalClient.

One sequence of operations, made from a numpy seed, runs on both
mempools: check_tx of new transactions, duplicates, oversized ones, ones
the app rejects and ones past the size and byte limits; reaps by bytes,
gas and count; update with committed and failed transactions; a recheck
in which the app drops some; the LRU cache's evictions.  Every outcome
(the error type and message, or the app's response), every reap, the
entries with their heights and sequence numbers, and the cache's
membership must be the same."""

import gc
import types

import numpy as np
import pytest
import torch

from cometbft_tpu import mempool as jmp
from cometbft_tpu.abci import client as jclient
from cometbft_tpu.abci import types as jat
from cometbft_tpu.apps import kvstore as jkv
from cometbft_tpu_torch import mempool as tmp
from cometbft_tpu_torch.abci import client as tclient
from cometbft_tpu_torch.abci import types as tat
from cometbft_tpu_torch.apps import kvstore as tkv

JAX = types.SimpleNamespace(mp=jmp, client=jclient, at=jat, kv=jkv)
PORT = types.SimpleNamespace(mp=tmp, client=tclient, at=tat, kv=tkv)
SEED = 20261021


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


def _app(ns):
    """The kvstore app, rejecting on recheck every tx whose key starts
    with "drop" (an app whose state moved under the pending txs)."""
    class App(ns.kv.KVStoreApplication):
        def check_tx(self, req):
            if req.type == ns.at.CHECK_TX_TYPE_RECHECK and \
                    req.tx.startswith(b"drop"):
                return ns.at.CheckTxResponse(code=7, log="stale")
            return super().check_tx(req)
    return App()


def _txs(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        key = ("drop" if rng.random() < 0.3 else "k") + f"{i}"
        out.append(f"{key}={int(rng.integers(0, 10**6))}".encode())
    return out


def _outcome(fn):
    try:
        r = fn()
    except Exception as e:               # noqa: BLE001
        return (type(e).__name__, str(e))
    if isinstance(r, list):
        return r
    return ("ok", getattr(r, "code", None), getattr(r, "gas_wanted", None))


def _entries(mp):
    return [(e.tx, e.height, e.gas_wanted, e.seq, sorted(e.senders))
            for e in mp.entries()]


def _run(ns, seed):
    app = _app(ns)
    mp = ns.mp.CListMempool(ns.client.LocalClient(app), size=8,
                            max_txs_bytes=120, max_tx_bytes=24,
                            cache_size=10)
    txs = _txs(seed, 14)
    log = []

    def step(name, fn):
        log.append((name, _outcome(fn), mp.size(), mp.size_bytes()))

    for i, tx in enumerate(txs[:6]):
        step(f"add{i}", lambda tx=tx, i=i: mp.check_tx(tx, f"p{i % 2}"))
    step("dup", lambda: mp.check_tx(txs[1], "p9"))
    step("dup-same-sender", lambda: mp.check_tx(txs[1]))
    step("too-large", lambda: mp.check_tx(b"k=" + b"v" * 30))
    step("app-reject", lambda: mp.check_tx(b"no-equals-sign"))
    step("app-reject-again", lambda: mp.check_tx(b"no-equals-sign"))
    for i, tx in enumerate(txs[6:12]):
        step(f"fill{i}", lambda tx=tx: mp.check_tx(tx))
    step("reap-bytes", lambda: mp.reap_max_bytes_max_gas(40, -1))
    step("reap-gas", lambda: mp.reap_max_bytes_max_gas(-1, 3))
    step("reap-all", lambda: mp.reap_max_bytes_max_gas(-1, -1))
    step("reap-n", lambda: mp.reap_max_txs(2))
    entries0 = _entries(mp)

    # a block commits two pending txs (one failed in the app) and one
    # the mempool never saw, then the rest is rechecked
    pending = [e.tx for e in mp.entries()]
    block = [pending[0], pending[2], txs[12]]
    results = [ns.at.ExecTxResult(code=0), ns.at.ExecTxResult(code=5),
               ns.at.ExecTxResult(code=0)]
    mp.lock()
    try:
        mp.update(1, block, results)
    finally:
        mp.unlock()
    log.append(("after-update", _entries(mp), mp.size_bytes()))
    step("readd-committed", lambda: mp.check_tx(block[0]))
    step("readd-failed", lambda: mp.check_tx(block[1]))
    step("add-after", lambda: mp.check_tx(txs[13]))
    cache = [mp.cache.has(tx) for tx in txs + [b"no-equals-sign"]]
    mp.flush()
    after_flush = (mp.size(), mp.size_bytes(), mp.cache.has(txs[0]))
    return log, entries0, cache, after_flush


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_same_outcomes_reaps_and_cache(seed):
    j, t = _run(JAX, seed), _run(PORT, seed)
    assert t == j
    names = [x[1][0] for x in t[0] if isinstance(x[1], tuple)]
    for err in ("ErrTxInCache", "ErrTxTooLarge", "ErrAppCheckTx",
                "ErrMempoolIsFull"):
        assert err in names


def test_lru_cache_evictions():
    rng = np.random.default_rng(SEED)
    ops = [(int(rng.integers(0, 3)), f"t{int(rng.integers(0, 12))}".encode())
           for _ in range(300)]
    seen = []
    for mp in (jmp, tmp):
        c = mp.LRUTxCache(5)
        out = []
        for op, tx in ops:
            if op == 0:
                out.append(c.push(tx))
            elif op == 1:
                c.remove(tx)
            else:
                out.append(c.has(tx))
        out.append([c.has(f"t{i}".encode()) for i in range(12)])
        c.reset()
        out.append(c.has(b"t0"))
        seen.append(out)
    assert seen[0] == seen[1]
    n = tmp.NopTxCache()
    assert n.push(b"a") and n.push(b"a") and not n.has(b"a")


def test_tx_key_and_nop_mempool():
    for tx in _txs(SEED, 5):
        assert tmp.tx_key(tx) == jmp.tx_key(tx)
    for mp in (jmp, tmp):
        nop = mp.NopMempool()
        assert nop.size() == 0 and nop.reap_max_bytes_max_gas(-1, -1) == []
        with pytest.raises(Exception, match="disabled"):
            nop.check_tx(b"a=1")


def test_wait_for_txs_and_txs_available():
    got = []
    for ns in (JAX, PORT):
        mp = ns.mp.CListMempool(ns.client.LocalClient(_app(ns)))
        mp.enable_txs_available()
        first = mp.wait_for_txs(0, timeout=0.01)
        mp.check_tx(b"a=1")
        got.append((first, mp.wait_for_txs(0, timeout=0.01),
                    mp.txs_available().is_set(),
                    [e.seq for e in mp.entries_after(0)]))
    assert got[0] == got[1] == (False, True, True, [1])
