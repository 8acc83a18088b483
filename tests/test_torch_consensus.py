"""The port's consensus engine (consensus/: messages, round types, WAL,
ticker, ConsensusState, ConsensusReactor) with its mempool, evidence
pool, FilePV and EventBus, against the JAX package on the CPU.

- Every consensus message encodes byte for byte as the JAX package's
  and each package decodes the other's; HeightVoteSet behaves the same.
- One validator on a ManualTicker steps through the same round states
  and schedules the same timeouts in both packages.
- Four port validators, each a full node (ConsensusState,
  ConsensusReactor, CListMempool, EvidencePool, FilePV, EventBus, a
  BlockExecutor over a kvstore LocalClient, a WAL), joined all to all
  over the loopback double of test_torch_blocksync (Net), commit kvstore
  transactions; every node stores the same blocks.  The JAX package's
  in-process network (tests/test_consensus.py make_node and bridge) runs
  the same transactions and ends with the same kvstore contents and app
  hash; each package verifies the other's commits and recomputes the
  other's block hashes from their bytes.
- Three of four validators still commit; an equivocating validator
  (tests/test_byzantine.py's _make_byzantine, on the port) has its
  DuplicateVoteEvidence committed in a later block.
- With batch.DEVICE_THRESHOLD at 2 every LastCommit check runs one plain
  RLC program (K1-K4); with the stream's threshold at 2 a window of
  gossiped votes runs one, and a window holding a tampered vote runs the
  program, then one plain K1 + K14, and the vote is not added.

The port runs on device="cpu", with the verdict cache on as a node runs
it (off where programs are counted), lock ranks in raise mode, and no
thread left behind."""

import gc
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from cometbft_tpu.consensus import messages as jmsgs
from cometbft_tpu.consensus import round_types as jrt
from cometbft_tpu.consensus import state as jstate
from cometbft_tpu.consensus import ticker as jticker
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import timestamp as jts
from cometbft_tpu.types import validator_set as jvs
from cometbft_tpu.types import vote as jvote
from cometbft_tpu_torch.abci import types as tat
from cometbft_tpu_torch.abci.client import LocalClient
from cometbft_tpu_torch.apps.kvstore import KVStoreApplication
from cometbft_tpu_torch.consensus import messages as tmsgs
from cometbft_tpu_torch.consensus import reactor as treactor
from cometbft_tpu_torch.consensus import round_types as trt
from cometbft_tpu_torch.consensus import state as tstate
from cometbft_tpu_torch.consensus import ticker as tticker
from cometbft_tpu_torch.consensus.wal import WAL, EndHeightMessage
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import dispatch as tdispatch
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import sigcache
from cometbft_tpu_torch.crypto import votestream
from cometbft_tpu_torch.evidence import EvidencePool
from cometbft_tpu_torch.libs import lockrank as plr
from cometbft_tpu_torch.mempool import CListMempool
from cometbft_tpu_torch.ops import cuda_decompress, cuda_msm, cuda_persig
from cometbft_tpu_torch.p2p.base_reactor import Envelope
from cometbft_tpu_torch.privval import FilePV
from cometbft_tpu_torch.state.execution import BlockExecutor
from cometbft_tpu_torch.state.state import make_genesis_state
from cometbft_tpu_torch.state.store import StateStore
from cometbft_tpu_torch.store.blockstore import BlockStore
from cometbft_tpu_torch.store.kv import MemDB
from cometbft_tpu_torch.types import block as tblock
from cometbft_tpu_torch.types import events as tev
from cometbft_tpu_torch.types import evidence as tevid
from cometbft_tpu_torch.types import genesis as tgen
from cometbft_tpu_torch.types import timestamp as tts
from cometbft_tpu_torch.types import validation as tval
from cometbft_tpu_torch.types import validator_set as tvs
from cometbft_tpu_torch.types import vote as tvote
from cometbft_tpu_torch.types import vote_set as tvset
from test_torch_blocksync import Net
from test_torch_wal import JAX as WJAX
from test_torch_wal import PORT as WPORT
from test_torch_wal import consensus_messages

CHAIN = "cs-chain"
T0 = 1_700_000_000
SEED = 20261023
TIMEOUT_S = 120.0


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
    """Lock ranks in raise mode, the port's verdict cache on and empty,
    no thread left behind."""
    plr.enable("raise")
    baseline = set(threading.enumerate())
    sigcache.reset()
    tvset.reset_verify_paths()
    yield
    sigcache.reset()
    sigcache.set_enabled(None)
    assert plr.violations() == []
    plr.disable()
    assert plr.leaked_threads(baseline, grace_s=2.0) == []


def _privs(n, salt=0):
    rng = np.random.default_rng(SEED + salt)
    return [ted.PrivKey.generate(rng.bytes(32)) for _ in range(n)]


def _txs(n, salt=0):
    rng = np.random.default_rng(SEED + 100 + salt)
    return [f"k{i}x{int(rng.integers(0, 10**6))}=v{int(rng.integers(0, 99))}"
            .encode() for i in range(n)]


def _wait(cond, what, timeout=TIMEOUT_S, nodes=()):
    deadline = time.monotonic() + timeout
    while not cond():
        for n in nodes:
            assert n.cs.crash_error is None, repr(n.cs.crash_error)
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


# -- wire messages and HeightVoteSet -----------------------------------------------

def test_messages_byte_equal_both_ways():
    jm, tm = consensus_messages(WJAX), consensus_messages(WPORT)
    assert len(jm) == len(tm) == 14
    for j, t in zip(jm, tm):
        wj, wt = jmsgs.wrap_message(j), tmsgs.wrap_message(t)
        assert wt == wj
        back_t, back_j = tmsgs.unwrap_message(wj), jmsgs.unwrap_message(wt)
        assert type(back_t).__name__ == type(t).__name__
        assert tmsgs.wrap_message(back_t) == jmsgs.wrap_message(back_j) == wj
    # each message validates the same way
    bad = [(jmsgs.NewRoundStepMessage(-1, 0, 1, 0, -1),
            tmsgs.NewRoundStepMessage(-1, 0, 1, 0, -1)),
           (jmsgs.NewRoundStepMessage(1, 0, 99, 0, -1),
            tmsgs.NewRoundStepMessage(1, 0, 99, 0, -1))]
    for j, t in bad:
        errs = []
        for m in (j, t):
            try:
                m.validate_basic()
                errs.append(None)
            except Exception as e:       # noqa: BLE001
                errs.append((type(e).__name__, str(e)))
        assert errs[0] == errs[1]


def _hvs_run(rt, vote_mod, vs_mod, block_mod, ts_mod, privs):
    vals = vs_mod.ValidatorSet([vs_mod.Validator(p.pub_key(), 10)
                                for p in privs])
    hvs = rt.HeightVoteSet(CHAIN, 5, vals)
    bid = block_mod.BlockID(b"\x01" * 32, block_mod.PartSetHeader(
        1, b"\x02" * 32))
    log = [hvs.prevotes(0) is not None, hvs.prevotes(3) is None]

    def vote(i, r, t=vote_mod.PREVOTE_TYPE, b=bid):
        addr = privs[i].pub_key().address()
        idx, _ = vals.get_by_address(addr)
        v = vote_mod.Vote(type=t, height=5, round=r, block_id=b,
                          timestamp=ts_mod.Timestamp(1, 0),
                          validator_address=addr, validator_index=idx)
        v.signature = privs[i].sign(v.sign_bytes(CHAIN))
        return v

    def outcome(fn):
        try:
            return ("ok", fn())
        except Exception as e:           # noqa: BLE001
            return (type(e).__name__,)

    for i in range(3):
        log.append(outcome(lambda i=i: hvs.add_vote(vote(i, 0), "p")))
    log.append(outcome(lambda: hvs.add_vote(vote(0, 0), "p")))
    log.append(hvs.pol_info()[0])
    log.append(hvs.prevotes(0).two_thirds_majority()[1])
    log.append(outcome(lambda: hvs.add_vote(vote(3, 7), "peerX")))
    log.append(outcome(lambda: hvs.add_vote(vote(3, 9), "peerX")))
    log.append(outcome(lambda: hvs.add_vote(vote(3, 11), "peerX")))
    hvs.set_round(2)
    log.append(hvs.prevotes(2) is not None)
    log.append(outcome(lambda: hvs.add_vote(
        vote(1, 2, vote_mod.PRECOMMIT_TYPE), "p")))
    log.append(outcome(lambda: hvs.set_peer_maj23(2, vote_mod.PREVOTE_TYPE,
                                                  "q", bid)))
    log.append(outcome(lambda: hvs.set_peer_maj23(2, 99, "q", bid)))
    log.append(sorted(hvs.round_vote_sets))
    return log


def test_height_vote_set_behaves_the_same():
    privs = _privs(4)
    jprivs = [jed.PrivKey(p.bytes()) for p in privs]
    j = _hvs_run(jrt, jvote, jvs, jblock, jts, jprivs)
    t = _hvs_run(trt, tvote, tvs, tblock, tts, privs)
    assert t == j
    assert ("ErrGotVoteFromUnwantedRound",) in t


# -- nodes --------------------------------------------------------------------------

def _genesis(privs, power=10):
    return tgen.GenesisDoc(
        chain_id=CHAIN, genesis_time=tts.Timestamp(T0, 0),
        validators=[tgen.GenesisValidator(pub_key=p.pub_key(), power=power)
                    for p in privs])


def port_node(priv, genesis, wal_dir=None, config=None, ticker=None):
    """One port validator: kvstore app after InitChain, mempool, evidence
    pool, state and block stores, event bus, executor, FilePV, WAL and
    ConsensusState, all on device="cpu"."""
    n = types.SimpleNamespace()
    state = make_genesis_state(genesis)
    n.app = KVStoreApplication()
    n.client = LocalClient(n.app)
    n.client.init_chain(tat.InitChainRequest(chain_id=genesis.chain_id,
                                             initial_height=1))
    n.mempool = CListMempool(n.client)
    n.sstore = StateStore(MemDB())
    n.sstore.bootstrap(state)
    n.bstore = BlockStore(MemDB())
    n.evpool = EvidencePool(MemDB(), n.sstore, n.bstore, device="cpu")
    n.bus = tev.EventBus()
    n.bus.start()
    n.exe = BlockExecutor(n.sstore, n.client, n.mempool, n.evpool,
                          block_store=n.bstore, event_bus=n.bus,
                          device="cpu")
    n.wal = WAL(str(wal_dir / "wal")) if wal_dir is not None else None
    n.cs = tstate.ConsensusState(
        config or tstate.test_consensus_config(), state, n.exe, n.bstore,
        wal=n.wal, priv_validator=FilePV(priv), event_bus=n.bus,
        ticker=ticker, evidence_pool=n.evpool, mempool=n.mempool,
        device="cpu")
    return n


class PortNet:
    """Port validators with consensus reactors over the loopback Net."""

    def __init__(self, privs, genesis, verifier, tmp_path=None, config=None,
                 started=None):
        self.net = Net()
        self.nodes = []
        for i, p in enumerate(privs):
            n = port_node(p, genesis,
                          None if tmp_path is None else tmp_path / f"n{i}",
                          config)
            n.reactor = treactor.ConsensusReactor(n.cs, device="cpu",
                                                  verifier=verifier)
            n.name = f"n{i}"
            self.nodes.append(n)
        self.started = self.nodes[:started]

    def start(self):
        for n in self.started:
            self.net.add(n.name, n.reactor).reactor.start()
        self.net.connect_all()

    def close(self):
        self.net.close()
        for n in self.nodes:
            n.bus.stop()
            if n.wal is not None:
                n.wal.close()

    def run_to(self, height, timeout=TIMEOUT_S):
        _wait(lambda: min(n.cs.height for n in self.started) > height,
              f"height {height}", timeout, self.started)

    def committed(self, n):
        return [n.bstore.load_block(h) for h in range(1, n.bstore.height() + 1)]


@pytest.fixture
def verifier():
    v = votestream.StreamingVerifier(device="cpu")
    v.start()
    yield v
    v.stop()


def _hashes(pnet, height):
    return [[n.bstore.load_block(h).hash() for h in range(1, height + 1)]
            for n in pnet.started]


# -- one validator, manual ticker ------------------------------------------------------

def _manual_run(ns, heights):
    """Drive one validator of `ns` to `heights` by firing each scheduled
    new-height timeout; record the round states and scheduled timeouts."""
    import cometbft_tpu.abci.client as jclient
    import cometbft_tpu.abci.types as jat
    import cometbft_tpu.apps.kvstore as jkv
    import cometbft_tpu.mempool as jmp
    import cometbft_tpu.privval as jpv
    import cometbft_tpu.state.execution as jexe
    import cometbft_tpu.state.state as jst
    import cometbft_tpu.state.store as jss
    import cometbft_tpu.store.blockstore as jbs
    import cometbft_tpu.store.kv as jkvdb
    import cometbft_tpu.types.events as jev
    import cometbft_tpu.types.genesis as jgen

    key = _privs(1, salt=7)[0].bytes()
    if ns == "port":
        priv = ted.PrivKey(key)
        ticker = tticker.ManualTicker()
        n = port_node(priv, _genesis([priv]), ticker=ticker)
        cs, steps = n.cs, trt.STEP_NAMES
    else:
        priv = jed.PrivKey(key)
        g = jgen.GenesisDoc(chain_id=CHAIN, genesis_time=jts.Timestamp(T0, 0),
                            validators=[jgen.GenesisValidator(
                                pub_key=priv.pub_key(), power=10)])
        state = jst.make_genesis_state(g)
        client = jclient.LocalClient(jkv.KVStoreApplication())
        client.init_chain(jat.InitChainRequest(chain_id=CHAIN,
                                               initial_height=1))
        mp = jmp.CListMempool(client)
        sstore = jss.StateStore(jkvdb.MemDB())
        sstore.bootstrap(state)
        bstore = jbs.BlockStore(jkvdb.MemDB())
        bus = jev.EventBus()
        exe = jexe.BlockExecutor(sstore, client, mp, block_store=bstore,
                                 event_bus=bus)
        ticker = jticker.ManualTicker()
        cs = jstate.ConsensusState(jstate.test_consensus_config(), state,
                                   exe, bstore, priv_validator=jpv.FilePV(
                                       priv), event_bus=bus, ticker=ticker,
                                   mempool=mp)
        steps = jrt.STEP_NAMES
    seen = []
    cs.listeners.append(lambda kind, c, data: seen.append(
        (kind, c.height, c.round, steps.get(c.step))) if kind in (
            "new_round_step", "valid_block") else None)
    cs.start()
    try:
        for _ in range(heights):
            h = cs.height
            _wait(lambda: any(t.step == trt.STEP_NEW_HEIGHT and
                              t.height == h for t in ticker.scheduled),
                  f"the new-height timeout of {h}")
            with cs._mtx:
                ticker.fire_matching(trt.STEP_NEW_HEIGHT)
            _wait(lambda: cs.height > h, f"height {h + 1}")
        sched = [(t.height, t.round, t.step,
                  t.duration_ns if t.step != trt.STEP_NEW_HEIGHT else None)
                 for t in ticker.scheduled]
    finally:
        cs.stop()
    if ns == "port":
        n.bus.stop()
    return seen, sched, cs.height


def test_one_validator_steps_through_the_same_round_states():
    j = _manual_run("jax", 4)
    t = _manual_run("port", 4)
    assert t == j
    assert t[2] == 5
    assert ("new_round_step", 4, 0, "RoundStepCommit") in t[0]


# -- four validators over the loopback ---------------------------------------------------

def _feed(nodes, txs):
    for i, tx in enumerate(txs):
        nodes[i % len(nodes)].mempool.check_tx(tx)


def _all_committed(n, txs):
    return all(n.app.kv.get(tx.split(b"=")[0].decode()) ==
               tx.split(b"=")[1].decode() for tx in txs)


def test_four_validators_commit_and_match_the_jax_network(
        tmp_path, verifier):
    privs = _privs(4)
    txs = _txs(24)
    pnet = PortNet(privs, _genesis(privs), verifier, tmp_path)
    _feed(pnet.nodes[:2], txs)
    pnet.start()
    try:
        pnet.run_to(5)
        _wait(lambda: all(_all_committed(n, txs) for n in pnet.nodes),
              "every tx committed", nodes=pnet.nodes)
        top = min(n.bstore.height() for n in pnet.nodes)
    finally:
        pnet.close()
    hashes = _hashes(pnet, top)
    assert all(h == hashes[0] for h in hashes) and top >= 5
    for n in pnet.nodes:
        assert n.app.app_hash == len(txs).to_bytes(8, "big")
        assert n.cs.crash_error is None
        blocks = pnet.committed(n)
        got = [tx for b in blocks for tx in b.data.txs]
        assert sorted(got) == sorted(txs)          # each tx once
        # the WAL ends every committed height
        w = WAL(str(tmp_path / n.name / "wal"))
        ends = {m.msg.height for m in w.replay()
                if isinstance(m.msg, EndHeightMessage)}
        w.close()
        assert set(range(1, top + 1)) <= ends
    # the vote stream carried the gossiped votes
    assert tvset.verify_paths().get("stream", 0) > 0
    assert sum(n.reactor.vote_paths["stream"] for n in pnet.nodes) > 0

    # the JAX package's network, same validators and transactions
    jnodes = _jax_network(privs, txs)
    kv = dict(pnet.nodes[0].app.kv)
    for jn in jnodes:
        assert jn.app.kv == kv
        assert jn.app.app_hash == pnet.nodes[0].app.app_hash
        assert jn.state.app_hash == pnet.nodes[0].cs.state.app_hash

    # each package verifies the other's commits and block bytes
    _cross_check((pnet.nodes[0].bstore, pnet.nodes[0].sstore),
                 (jnodes[0].block_store, jnodes[0].block_exec.store))


def _jax_network(privs, txs):
    """tests/test_consensus.py's make_node / bridge network, run until
    every tx is committed on every node."""
    from cometbft_tpu.crypto.ed25519 import PrivKey as JPriv
    from tests.test_consensus import bridge, make_genesis, make_node

    old = os.environ.get("COMETBFT_TPU_PROVIDER")
    os.environ["COMETBFT_TPU_PROVIDER"] = "cpu"
    jprivs = [JPriv(p.bytes()) for p in privs]
    g = make_genesis(jprivs)
    g.chain_id = CHAIN
    nodes = [make_node(p, g, None, f"j{i}") for i, p in enumerate(jprivs)]
    for i, tx in enumerate(txs):
        nodes[i % 2].mempool_.check_tx(tx)
    bridge(nodes)
    for n in nodes:
        n.start()
    try:
        _wait(lambda: all(n.app.app_hash == len(txs).to_bytes(8, "big")
                          for n in nodes), "the JAX network's txs")
        _wait(lambda: min(n.height for n in nodes) > 3, "JAX height 3")
    finally:
        for n in nodes:
            n.stop()
        if old is None:
            os.environ.pop("COMETBFT_TPU_PROVIDER")
        else:
            os.environ["COMETBFT_TPU_PROVIDER"] = old
    return nodes


def _cross_check(port, jax):
    """Every port block's commit passes the JAX package's
    ValidatorSet.verify_commit and its bytes give the JAX package the
    same header hash; and the reverse.  (block store, state store)
    pairs."""
    from cometbft_tpu.types import validation as jval

    old = os.environ.get("COMETBFT_TPU_PROVIDER")
    os.environ["COMETBFT_TPU_PROVIDER"] = "cpu"
    try:
        for (src, sstore), dst in ((port, "jax"), (jax, "port")):
            top = src.height()
            assert top >= 3
            for h in range(1, top):
                raw = src.load_block_bytes(h)
                commit = src.load_block(h + 1).last_commit
                seen = src.load_seen_commit(h)
                vproto = sstore.load_validators(h).to_proto()
                mod = (jblock, jvs) if dst == "jax" else (tblock, tvs)
                b = mod[0].Block.from_proto(raw)
                vals = mod[1].ValidatorSet.from_proto(vproto)
                assert b.hash() == src.load_block(h).hash()
                for c in (commit, seen):
                    c = mod[0].Commit.from_proto(c.to_proto())
                    assert c.block_id.hash == b.hash()
                    if dst == "jax":
                        vals.verify_commit(CHAIN, c.block_id, h, c)
                        jval.verify_commit(CHAIN, vals, c.block_id, h, c)
                    else:
                        tval.verify_commit(CHAIN, vals, c.block_id, h, c,
                                           device="cpu")
    finally:
        if old is None:
            os.environ.pop("COMETBFT_TPU_PROVIDER")
        else:
            os.environ["COMETBFT_TPU_PROVIDER"] = old


def test_three_of_four_still_commit(verifier):
    privs = _privs(4, salt=1)
    pnet = PortNet(privs, _genesis(privs), verifier, started=3)
    pnet.start()
    try:
        pnet.run_to(3)
    finally:
        pnet.close()
    hashes = _hashes(pnet, 3)
    assert all(h == hashes[0] for h in hashes)
    c = pnet.nodes[0].bstore.load_seen_commit(2)
    assert sum(1 for s in c.signatures if s.signature) == 3


def _make_byzantine(node, priv):
    """tests/test_byzantine.py's _make_byzantine on a port node: after
    its honest prevote, sign a conflicting prevote with the raw key (the
    FilePV would refuse) and send it to every peer."""
    cs = node.cs
    orig = cs._sign_add_vote

    def byz_sign_add_vote(msg_type, hash_, header, block=None):
        orig(msg_type, hash_, header, block)
        if msg_type != tvote.PREVOTE_TYPE or not hash_:
            return
        addr = cs.priv_validator_pub_key.address()
        val_idx, _ = cs.validators.get_by_address(addr)
        conflicting = tvote.Vote(
            type=tvote.PREVOTE_TYPE, height=cs.height, round=cs.round,
            block_id=tblock.BlockID(os.urandom(32),
                                    tblock.PartSetHeader(1, os.urandom(32))),
            timestamp=tts.Timestamp.now(),
            validator_address=addr, validator_index=val_idx)
        conflicting.signature = priv.sign(
            conflicting.sign_bytes(cs.state.chain_id))
        msg = tmsgs.wrap_message(tmsgs.VoteMessage(conflicting))
        for peer in node.reactor.switch.peers.list():
            peer.try_send(treactor.VOTE_CHANNEL, msg)

    cs._sign_add_vote = byz_sign_add_vote
    orig_try_add = cs._try_add_vote

    def byz_try_add_vote(vote, peer_id):
        try:
            return orig_try_add(vote, peer_id)
        except Exception:                # noqa: BLE001
            return False

    cs._try_add_vote = byz_try_add_vote


def _evidence_of(n, addr):
    for h in range(1, n.bstore.height() + 1):
        for ev in n.bstore.load_block(h).evidence:
            if isinstance(ev, tevid.DuplicateVoteEvidence) and \
                    ev.vote_a.validator_address == addr:
                return h, ev
    return None


def test_equivocation_evidence_is_committed(verifier):
    privs = _privs(4, salt=2)
    pnet = PortNet(privs, _genesis(privs), verifier)
    _make_byzantine(pnet.nodes[0], privs[0])
    addr = privs[0].pub_key().address()
    pnet.start()
    try:
        _wait(lambda: all(_evidence_of(n, addr) for n in pnet.nodes[1:]),
              "committed duplicate-vote evidence", nodes=pnet.nodes[1:])
        found = _evidence_of(pnet.nodes[1], addr)
        top = found[0] + 1
        pnet.run_to(top)
    finally:
        pnet.close()
    h, ev = found
    assert ev.vote_a.height < h
    assert ev.vote_a.block_id != ev.vote_b.block_id
    hashes = _hashes(pnet, top)
    assert all(x == hashes[0] for x in hashes)
    # every node validated and applied the block with the evidence
    for n in pnet.nodes:
        assert n.bstore.load_block(h).evidence[0].hash() == ev.hash()
        assert n.cs.height > h


# -- the plain kernels ----------------------------------------------------------------

@pytest.fixture
def counted(monkeypatch):
    """The verdict cache off, both thresholds at 2, and the plain K1, K4
    and K14 counted."""
    monkeypatch.setattr(sigcache, "_enabled_override", False)
    monkeypatch.setattr(tval.DeferredSigBatch, "DEVICE_THRESHOLD", 2)
    monkeypatch.setattr(tbatch, "DEVICE_THRESHOLD", 2)
    calls = {"k1": 0, "k4": 0, "k14": [], "lastcommit": 0}
    k1, k4, k14 = (cuda_decompress.decompress_plain,
                   cuda_msm.fold_verify_plain,
                   cuda_persig.verify_ladder_plain)
    lock = threading.Lock()

    def c1(*a):
        with lock:
            calls["k1"] += 1
        return k1(*a)

    def c4(*a):
        with lock:
            calls["k4"] += 1
        return k4(*a)

    def c14(pts, oks, s_limbs, h_limbs, return_acc=False):
        with lock:
            calls["k14"].append(s_limbs.shape[-1])
        return k14(pts, oks, s_limbs, h_limbs, return_acc)

    monkeypatch.setattr(cuda_decompress, "decompress_plain", c1)
    monkeypatch.setattr(cuda_msm, "fold_verify_plain", c4)
    monkeypatch.setattr(cuda_persig, "verify_ladder_plain", c14)
    verify_commit = tval.verify_commit

    def vc(*a, **k):
        with lock:
            calls["lastcommit"] += 1
        return verify_commit(*a, **k)

    import cometbft_tpu_torch.state.validation as sval
    monkeypatch.setattr(sval, "verify_commit", vc, raising=False)
    monkeypatch.setattr(tval, "verify_commit", vc)
    return calls


def test_lastcommit_checks_run_the_plain_rlc_program(counted, verifier):
    """Every LastCommit check (3-4 signatures) is one RLC program: one
    plain K4 each, and no localization."""
    privs = _privs(4, salt=3)
    cfg = tstate.ConsensusConfig(timeout_propose=2.0, timeout_prevote=0.5,
                                 timeout_precommit=0.5, timeout_commit=0.05)
    pnet = PortNet(privs, _genesis(privs), verifier, config=cfg)
    pnet.start()
    try:
        pnet.run_to(2)
    finally:
        pnet.close()
    assert counted["lastcommit"] >= 4
    assert counted["k4"] == counted["lastcommit"]
    assert counted["k1"] == 2 * counted["k4"]
    assert counted["k14"] == []


def test_vote_windows_and_a_tampered_vote(counted, tmp_path):
    """Gossiped votes reach the reactor of a node at height 1: a window
    of three honest prevotes runs one plain RLC program and all three are
    added; a window of three with one tampered signature runs the
    program, then one plain K1 + K14 over its three votes, and only the
    two honest ones are added."""
    privs = _privs(4, salt=4)
    n = port_node(privs[0], _genesis(privs))
    with tdispatch.VerifyPipeline(device="cpu", host_workers=1) as pipe:
        stream = votestream.StreamingVerifier(
            device="cpu", device_threshold=2, flush_interval=0.3,
            pipeline=pipe)
        stream.start()
        try:
            r = treactor.ConsensusReactor(n.cs, device="cpu",
                                          verifier=stream)
            peer = types.SimpleNamespace(id="peer", data={}, sent=[])
            peer.set = peer.data.__setitem__
            peer.get = peer.data.get
            peer.send = peer.try_send = lambda *a, **k: True
            r.init_peer(peer)
            vals = n.cs.validators
            bid = tblock.BlockID(b"\x05" * 32,
                                 tblock.PartSetHeader(1, b"\x06" * 32))

            def vote(p, rnd, tamper=False):
                addr = p.pub_key().address()
                idx, _ = vals.get_by_address(addr)
                v = tvote.Vote(type=tvote.PREVOTE_TYPE, height=1, round=rnd,
                               block_id=bid, timestamp=tts.Timestamp(T0, 5),
                               validator_address=addr, validator_index=idx)
                v.signature = p.sign(v.sign_bytes(CHAIN))
                if tamper:
                    v.signature = bytes([v.signature[0] ^ 1]) + \
                        v.signature[1:]
                return v

            results = []
            for rnd, bad in ((0, None), (1, 2)):
                before = dict(counted, k14=list(counted["k14"]))
                votes = [vote(p, rnd, i + 1 == bad)
                         for i, p in enumerate(privs[1:])]
                for v in votes:
                    r.receive(Envelope(src=peer, channel_id=treactor.
                                       VOTE_CHANNEL, message=tmsgs.
                                       wrap_message(tmsgs.VoteMessage(v))))
                _wait(lambda: n.cs.peer_msg_queue.qsize() == 3,
                      "three queued votes")
                items = [n.cs.peer_msg_queue.get() for _ in range(3)]
                _wait(lambda: all(it.msg.vote.preverified.future.done()
                                  for it in items), "the window's verdicts")
                with n.cs._mtx:
                    n.cs.votes.set_round(rnd + 1)
                    for it in items:
                        n.cs._dispatch(it)
                vs = n.cs.votes.prevotes(rnd)
                results.append((
                    [vs.get_by_index(vals.get_by_address(
                        p.pub_key().address())[0]) is not None
                     for p in privs[1:]],
                    counted["k1"] - before["k1"],
                    counted["k4"] - before["k4"],
                    counted["k14"][len(before["k14"]):]))
        finally:
            stream.stop()
            n.cs.stop()
            n.bus.stop()
    assert results[0] == ([True, True, True], 2, 1, [])
    assert results[1] == ([True, False, True], 3, 1, [3])
    assert r.vote_paths["stream"] == 6
    assert tvset.verify_paths() == {"stream": 6}
    assert stream.path_flushes["device"] == 2


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    privs = _privs(1)
    n = port_node(privs[0], _genesis(privs))
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            treactor.ConsensusReactor(n.cs)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tstate.ConsensusState(tstate.test_consensus_config(),
                                  n.cs.state, n.exe, n.bstore)
    finally:
        n.bus.stop()


def test_a_peers_part_of_another_proposal_is_dropped():
    """A block part that does not prove against the part set being
    assembled (another round's proposal, a catch-up part of another
    block) from a peer: the port logs and drops it, as CometBFT's
    handleMsg does; the JAX package's _handle_msg raises PartSetError,
    which stops its state machine (ROADMAP Queue C).  The port's own
    messages stay fatal."""
    from cometbft_tpu.crypto.ed25519 import PrivKey as JPriv
    from cometbft_tpu.types.part_set import PartSet as JPartSet
    from cometbft_tpu.types.part_set import PartSetError as JPartSetError
    from cometbft_tpu_torch.types.part_set import PartSet, PartSetError
    from tests.test_consensus import make_genesis, make_node

    privs = _privs(1, salt=5)
    n = port_node(privs[0], _genesis(privs))
    jp = JPriv(privs[0].bytes())
    jcs = make_node(jp, make_genesis([jp]))
    try:
        for cs, ps_cls, mods in ((n.cs, PartSet, tmsgs),
                                 (jcs, JPartSet, jmsgs)):
            ours = ps_cls.from_data(b"a" * 300, 100)
            other = ps_cls.from_data(b"b" * 300, 100)
            cs.proposal_block_parts = ps_cls.new_from_header(ours.header)
            msg = mods.BlockPartMessage(1, 0, other.get_part(1))
            if cs is n.cs:
                with cs._mtx:
                    cs._handle_msg(msg, "peer")
                assert cs.proposal_block_parts.count == 0
                with pytest.raises(PartSetError), cs._mtx:
                    cs._handle_msg(msg, "")
                # the right part still goes in
                with cs._mtx:
                    cs._handle_msg(mods.BlockPartMessage(
                        1, 0, ours.get_part(1)), "peer")
                assert cs.proposal_block_parts.count == 1
            else:
                with pytest.raises(JPartSetError), cs._mtx:
                    cs._handle_msg(msg, "peer")
    finally:
        n.cs.stop()
        n.bus.stop()
        jcs.stop()
