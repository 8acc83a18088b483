"""The port's pubsub server and typed EventBus (libs/pubsub.py,
types/events.py) against the JAX package's, on the CPU.

The same query strings parse to the same conditions (or fail the same
way) in both packages, and match the same attribute maps, made from a
numpy seed.  The event maps (ABCI events flattened, block and tx maps)
are equal, and an EventBus fed the same publications delivers the same
events in the same order to the same subscriptions, with the same
overflow cancellations."""

import gc
import types

import numpy as np
import pytest
import torch

from cometbft_tpu.abci import types as jat
from cometbft_tpu.libs import pubsub as jps
from cometbft_tpu.types import events as jev
from cometbft_tpu_torch.abci import types as tat
from cometbft_tpu_torch.libs import pubsub as tps
from cometbft_tpu_torch.types import events as tev

JAX = types.SimpleNamespace(ps=jps, ev=jev, at=jat)
PORT = types.SimpleNamespace(ps=tps, ev=tev, at=tat)
SIDES = (JAX, PORT)
SEED = 20261019

QUERIES = [
    "tm.event = 'NewBlock'",
    "tm.event = 'Tx' AND tx.height > 5",
    "tx.height >= 3 AND tx.height <= 7",
    "tx.height < 4",
    "tx.hash CONTAINS 'AB'",
    "account.owner EXISTS",
    "account.owner = 'alice' AND transfer.amount > 10.5",
    "block.height = 12",
    "app.created = DATE 2026-01-02",
    "app.time > TIME 2026-01-02T03:04:05Z",
    "transfer.amount = -3",
    "  tm.event='Vote'  ", "",
]
BAD_QUERIES = [
    "tm.event", "tm.event =", "= 'x'", "a = 'x' AND", "a = 'x' OR b = 1",
    "a CONTAINS 5", "a = 'x' b = 'y'", "a ~ 'x'", "a > x",
]
KEYS = ["tm.event", "tx.height", "tx.hash", "account.owner",
        "transfer.amount", "block.height", "app.created", "app.time"]
VALUES = {
    "tm.event": ["NewBlock", "Tx", "Vote", "Lock"],
    "tx.height": ["1", "3", "5", "6", "7", "9", "x"],
    "tx.hash": ["AB12", "CDAB", "0000", "ab"],
    "account.owner": ["alice", "bob", ""],
    "transfer.amount": ["10.5", "11", "-3", "2", "big"],
    "block.height": ["12", "12.0", "13"],
    "app.created": ["2026-01-02", "2025-12-31"],
    "app.time": ["2026-01-02T03:04:05Z", "2026-01-02T03:04:06Z"],
}


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


def _parse(ns, q):
    try:
        c = ns.ps.Query.parse(q).conditions
        return [(x.key, x.op, x.value) for x in c]
    except Exception as e:               # noqa: BLE001
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("q", QUERIES + BAD_QUERIES)
def test_query_parse(q):
    j, t = _parse(JAX, q), _parse(PORT, q)
    assert j == t
    if q in BAD_QUERIES:
        assert j[0] == "QueryError"


def _event_maps(rng, n):
    maps = []
    for _ in range(n):
        m = {}
        for k in KEYS:
            if rng.random() < 0.6:
                vals = VALUES[k]
                m[k] = [vals[int(i)] for i in
                        rng.integers(0, len(vals), int(rng.integers(1, 3)))]
        maps.append(m)
    return maps


def test_query_matches():
    maps = _event_maps(np.random.default_rng(SEED), 200)
    hits = 0
    for q in QUERIES:
        jq, tq = jps.Query.parse(q), tps.Query.parse(q)
        for m in maps:
            j = jq.matches(m)
            assert tq.matches(m) == j, (q, m)
            hits += j
    assert hits > 50
    assert tps.ALL.matches({}) and jps.ALL.matches({})


def _abci_events(ns, rng, n):
    out = []
    for i in range(n):
        attrs = [ns.at.EventAttribute(key=f"k{int(rng.integers(0, 3))}",
                                      value=f"v{int(rng.integers(0, 99))}",
                                      index=bool(rng.integers(0, 2)))
                 for _ in range(int(rng.integers(0, 4)))]
        attrs.append(ns.at.EventAttribute(key="", value="dropped"))
        out.append(ns.at.Event(type=["transfer", "app", ""][i % 3],
                               attributes=attrs))
    return out


def test_event_maps():
    for seed in range(5):
        j = _abci_events(JAX, np.random.default_rng(seed), 7)
        t = _abci_events(PORT, np.random.default_rng(seed), 7)
        assert tev.abci_events_to_map(t) == jev.abci_events_to_map(j)
        assert tev.abci_events_to_map(t, {"a.b": ["1"]}) == \
            jev.abci_events_to_map(j, {"a.b": ["1"]})
        assert tev.block_events_map(seed + 3, t) == \
            jev.block_events_map(seed + 3, j)
        tx = bytes(np.random.default_rng(seed).integers(0, 256, 40,
                                                        dtype=np.uint8))
        assert tev.tx_events_map(9, tx, t) == jev.tx_events_map(9, tx, j)
    for name in dir(jev):
        if name.startswith("EVENT_") or name.endswith("_KEY"):
            assert getattr(tev, name) == getattr(jev, name), name
            if name.startswith("EVENT_") and name != "EVENT_TYPE_KEY":
                jq = jev.query_for_event(getattr(jev, name))
                tq = tev.query_for_event(getattr(tev, name))
                assert str(tq) == str(jq)
                assert [(c.key, c.op, c.value) for c in tq.conditions] == \
                    [(c.key, c.op, c.value) for c in jq.conditions]


SUBSCRIPTIONS = [
    ("a", "tm.event = 'NewBlock'", 100),
    ("a", "tm.event = 'Tx' AND tx.height > 1", 100),
    ("b", "transfer.k1 EXISTS", 100),
    ("b", "tm.event = 'Vote'", 2),            # overflows: cancelled
    ("c", "block.height >= 2", 100),
    ("d", "tm.event = 'NewRoundStep' AND tm.event EXISTS", 100),
]


def _publish_all(ns, bus, seed):
    rng = np.random.default_rng(seed)
    ev = ns.ev
    for h in range(1, 4):
        fin = ns.at.FinalizeBlockResponse(events=_abci_events(ns, rng, 3))
        blk = types.SimpleNamespace(header=types.SimpleNamespace(height=h))
        bus.publish_new_round_step(ev.EventDataRoundState(h, 0, "Propose"))
        bus.publish_new_round(ev.EventDataNewRound(h, 0, "NewRound",
                                                   b"\x01" * 20))
        bus.publish_complete_proposal(ev.EventDataCompleteProposal(
            h, 0, "Propose", None))
        for i in range(2):
            bus.publish_vote(ev.EventDataVote(vote=(h, i)))
        bus.publish_polka(ev.EventDataRoundState(h, 0, "Prevote"))
        bus.publish_lock(ev.EventDataRoundState(h, 0, "Precommit"))
        bus.publish_new_block(ev.EventDataNewBlock(blk, None, fin))
        bus.publish_new_block_header(ev.EventDataNewBlockHeader(blk.header))
        bus.publish_new_block_events(ev.EventDataNewBlockEvents(
            h, _abci_events(ns, rng, 2), 1))
        for i in range(2):
            res = ns.at.ExecTxResult(events=_abci_events(ns, rng, 2))
            bus.publish_tx(ev.EventDataTx(h, i, b"tx%d%d" % (h, i), res))
        bus.publish_timeout_wait(ev.EventDataRoundState(h, 0, "X"))


def _deliveries(ns, seed):
    bus = ns.ev.EventBus()
    bus.start()
    subs = [(who, q, bus.subscribe(who, ns.ps.Query.parse(q), cap))
            for who, q, cap in SUBSCRIPTIONS]
    _publish_all(ns, bus, seed)
    out = []
    for who, q, sub in subs:
        got = []
        while True:
            m = sub.next(timeout=0)
            if m is None:
                break
            got.append((type(m.data).__name__, sorted(m.events.items())))
        out.append((who, q, sub.canceled.is_set(), sub.cancel_reason, got))
    clients = bus.server.num_clients()
    per = [bus.server.num_client_subscriptions(w) for w in "abcd"]
    bus.unsubscribe("a", ns.ps.Query.parse(SUBSCRIPTIONS[0][1]))
    bus.unsubscribe_all("c")
    errs = []
    for fn in (lambda: bus.unsubscribe_all("c"),
               lambda: bus.subscribe("a", ns.ps.Query.parse(
                   SUBSCRIPTIONS[1][1]))):
        try:
            fn()
        except Exception as e:           # noqa: BLE001
            errs.append(type(e).__name__)
    bus.stop()
    return out, clients, per, errs, bus.server.num_clients()


def test_event_bus_delivers_same_events_in_order():
    j = _deliveries(JAX, SEED)
    t = _deliveries(PORT, SEED)
    assert t == j
    out = t[0]
    assert all(got for *_, got in out)
    # the 2-slot vote subscription overflowed and was cancelled
    assert out[3][2] and "not pulling" in out[3][3]
    assert t[3] == ["KeyError", "ValueError"]


def test_nop_event_bus():
    for ns in SIDES:
        bus = ns.ev.NopEventBus()
        assert bus.publish_vote(None) is None
        with pytest.raises(AttributeError):
            bus.subscribe
