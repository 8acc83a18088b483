"""The port's reactors over its real p2p stack (p2p/switch.py,
transport.py, SecretConnection, MConnection) on 127.0.0.1, and the
mempool and evidence reactors' wire messages against the JAX package.

- encode_txs / decode_txs and encode_evidence_list /
  decode_evidence_list: byte for byte the JAX package's.
- Two mempool-only switches: a transaction checked on one reaches the
  other's mempool through the broadcast routine alone.
- Two evidence switches over the port's copy of the test_torch_execution
  chain: pending DuplicateVoteEvidence reaches the other pool verified;
  a forged one gets its sender stopped.
- Four port validators (device="cpu"), each a full node (consensus,
  mempool, evidence and blocksync reactors on a Switch over a kvstore
  app) in a full mesh: at least three heights committed with the same
  hashes, a transaction checked on one node only gossiped to the others
  and committed once; then a fifth, non-validator node joins, catches up
  by block sync over TCP and reaches the validators' app hash.

Lock ranks in raise mode and no thread left behind."""

import gc
import threading
import time
import types

import pytest
import torch

from cometbft_tpu.evidence import reactor as jer
from cometbft_tpu.mempool import reactor as jmr
from cometbft_tpu_torch.abci import types as tat
from cometbft_tpu_torch.abci.client import LocalClient
from cometbft_tpu_torch.apps.kvstore import KVStoreApplication
from cometbft_tpu_torch.blocksync.reactor import BlocksyncReactor
from cometbft_tpu_torch.consensus import state as tstate
from cometbft_tpu_torch.consensus.reactor import ConsensusReactor
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import sigcache, votestream
from cometbft_tpu_torch.evidence import EvidencePool
from cometbft_tpu_torch.evidence import reactor as ter
from cometbft_tpu_torch.libs import lockrank as plr
from cometbft_tpu_torch.mempool import CListMempool
from cometbft_tpu_torch.mempool import reactor as tmr
from cometbft_tpu_torch.p2p import NodeInfo, NodeKey, Switch
from cometbft_tpu_torch.p2p.transport import MultiplexTransport
from cometbft_tpu_torch.privval import FilePV
from cometbft_tpu_torch.state.execution import BlockExecutor
from cometbft_tpu_torch.state.state import make_genesis_state
from cometbft_tpu_torch.state.store import StateStore
from cometbft_tpu_torch.store.blockstore import BlockStore
from cometbft_tpu_torch.store.kv import MemDB
from cometbft_tpu_torch.types import events as tev
from cometbft_tpu_torch.types import evidence as tevid
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.types.timestamp import Timestamp
from test_torch_evidence import JAX as EJAX
from test_torch_evidence import PORT as EPORT
from test_torch_evidence import _dup
from test_torch_execution import JAX, PORT, build_chain, chain_spec

CHAIN = "p2p-chain"
CHANNELS = bytes([0x20, 0x21, 0x22, 0x23, 0x30, 0x38, 0x40])
TIMEOUT_S = 60.0


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
    plr.enable("raise")
    baseline = set(threading.enumerate())
    sigcache.reset()
    yield
    sigcache.reset()
    sigcache.set_enabled(None)
    assert plr.violations() == []
    plr.disable()
    assert plr.leaked_threads(baseline, grace_s=5.0) == []


def _wait(cond, what, timeout=TIMEOUT_S, nodes=()):
    deadline = time.monotonic() + timeout
    while not cond():
        for n in nodes:
            if n.cs.crash_error is not None:
                raise n.cs.crash_error
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def _switch(seed, network, moniker, channels=CHANNELS):
    key = NodeKey(ted.PrivKey.generate(seed))
    info = NodeInfo(node_id=key.id, network=network, channels=channels,
                    moniker=moniker)
    return key, Switch(MultiplexTransport(key, info),
                       listen_addr="127.0.0.1:0")


def _dial(a, b):
    """a dials b; both see the peer."""
    a.sw.dial_peer(f"{b.key.id}@{b.sw.bound_addr}")
    _wait(lambda: b.sw.peers.has(a.key.id), "the inbound peer", 20)


# -- wire messages ------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 3, 40])
def test_mempool_messages_equal_jax(n):
    txs = [b"k%d=%s" % (i, b"v" * (i * 37 % 300)) for i in range(n)]
    wire = tmr.encode_txs(txs)
    assert wire == jmr.encode_txs(txs)
    assert tmr.decode_txs(wire) == jmr.decode_txs(wire) == txs


@pytest.fixture(scope="module")
def chains():
    spec = chain_spec()
    return build_chain(JAX, spec), build_chain(PORT, spec)


@pytest.mark.parametrize("cases", [("ok",), ("ok", "joiner"),
                                   ("forged", "two_heights")])
def test_evidence_messages_equal_jax(chains, cases):
    jc, tc = chains
    jevs = [_dup(EJAX, jc, c) for c in cases]
    tevs = [_dup(EPORT, tc, c) for c in cases]
    wire = ter.encode_evidence_list(tevs)
    assert wire == jer.encode_evidence_list(jevs)
    assert [tevid.evidence_to_proto_wrapped(e)
            for e in ter.decode_evidence_list(wire)] == \
        [tevid.evidence_to_proto_wrapped(e) for e in tevs]
    assert len(jer.decode_evidence_list(wire)) == len(cases)
    assert ter.EVIDENCE_CHANNEL == jer.EVIDENCE_CHANNEL
    assert tmr.MEMPOOL_CHANNEL == jmr.MEMPOOL_CHANNEL


# -- two switches ------------------------------------------------------------------------

def test_mempool_gossip_between_two_switches():
    sides = []
    for i in range(2):
        n = types.SimpleNamespace()
        n.client = LocalClient(KVStoreApplication())
        n.mempool = CListMempool(n.client)
        n.key, n.sw = _switch(bytes([50 + i]) * 32, "gossip", f"m{i}",
                              bytes([0x30]))
        n.reactor = tmr.MempoolReactor(n.mempool)
        n.sw.add_reactor("MEMPOOL", n.reactor)
        n.sw.start()
        sides.append(n)
    a, b = sides
    try:
        _dial(b, a)
        a.mempool.check_tx(b"direct=gossip")
        _wait(lambda: b.mempool.size() == 1, "the gossiped tx")
        entry = b.mempool.entries_after(0)[0]
        assert entry.tx == b"direct=gossip" and entry.senders == {a.key.id}
        # a tx b received from a is not sent back to a
        time.sleep(0.3)
        assert a.mempool.size() == 1
    finally:
        for n in sides:
            n.sw.stop()


def test_evidence_gossip_verified_and_forged_sender_stopped(chains):
    """Pending evidence on one pool reaches the other over the wire and
    is verified there (device="cpu"); a node sending forged evidence is
    stopped by its peer."""
    _, tc = chains
    sides = []
    for i in range(2):
        n = types.SimpleNamespace()
        n.pool = EvidencePool(MemDB(), tc.sstore, tc.bstore, device="cpu")
        n.key, n.sw = _switch(bytes([60 + i]) * 32, "ev", f"e{i}",
                              bytes([0x38]))
        n.reactor = ter.EvidenceReactor(n.pool)
        n.sw.add_reactor("EVIDENCE", n.reactor)
        sides.append(n)
    a, b = sides
    ev = _dup(EPORT, tc, "ok")
    a.pool.add_evidence(ev)
    for n in sides:
        n.sw.start()
    try:
        _dial(b, a)
        _wait(lambda: b.pool._is_pending(ev), "the gossiped evidence")
        assert b.reactor.error is None
        forged = _dup(EPORT, tc, "forged")
        a.sw.peers.get(b.key.id).send(ter.EVIDENCE_CHANNEL,
                                      ter.encode_evidence_list([forged]))
        _wait(lambda: b.sw.peers.size() == 0, "the forger's stop")
        assert not b.pool._is_pending(forged)
        assert b.reactor.error is None
    finally:
        for n in sides:
            n.sw.stop()


# -- a network of full nodes ---------------------------------------------------------

def _config():
    """Round timeouts the in-process TCP network decides heights at on a
    loaded CPU (test_consensus_config's 20-80 ms time rounds out before
    the pure-Python ciphers deliver their gossip)."""
    return tstate.ConsensusConfig(
        timeout_propose=0.4, timeout_propose_delta=0.1,
        timeout_prevote=0.2, timeout_prevote_delta=0.1,
        timeout_precommit=0.2, timeout_precommit_delta=0.1,
        timeout_commit=0.05)


class P2PNode:
    """A full port node on device="cpu": a Switch with the consensus,
    mempool, evidence and blocksync reactors over a kvstore app."""

    def __init__(self, priv, genesis, i, verifier, block_sync=False):
        st = make_genesis_state(genesis)
        self.app = KVStoreApplication()
        self.client = LocalClient(self.app)
        self.client.init_chain(tat.InitChainRequest(
            chain_id=genesis.chain_id, initial_height=1))
        self.mempool = CListMempool(self.client)
        self.sstore = StateStore(MemDB())
        self.sstore.bootstrap(st)
        self.bstore = BlockStore(MemDB())
        self.evpool = EvidencePool(MemDB(), self.sstore, self.bstore,
                                   device="cpu")
        self.bus = tev.EventBus()
        self.bus.start()
        self.exe = BlockExecutor(self.sstore, self.client, self.mempool,
                                 self.evpool, block_store=self.bstore,
                                 event_bus=self.bus, device="cpu")
        self.cs = tstate.ConsensusState(
            _config(), st, self.exe, self.bstore,
            priv_validator=FilePV(priv) if priv is not None else None,
            event_bus=self.bus, evidence_pool=self.evpool,
            mempool=self.mempool, device="cpu")
        self.key, self.sw = _switch(bytes([70 + i]) * 32, genesis.chain_id,
                                    f"node{i}")
        self.consensus = ConsensusReactor(self.cs, wait_sync=block_sync,
                                          device="cpu", verifier=verifier)
        self.blocksync = BlocksyncReactor(st, self.exe, self.bstore,
                                          block_sync,
                                          consensus_reactor=self.consensus,
                                          device="cpu")
        self.mempool_reactor = tmr.MempoolReactor(self.mempool)
        self.evidence = ter.EvidenceReactor(self.evpool)
        self.sw.add_reactor("CONSENSUS", self.consensus)
        self.sw.add_reactor("MEMPOOL", self.mempool_reactor)
        self.sw.add_reactor("EVIDENCE", self.evidence)
        self.sw.add_reactor("BLOCKSYNC", self.blocksync)

    def stop(self):
        self.sw.stop()
        self.bus.stop()


def test_four_validators_gossip_commit_and_a_late_joiner_syncs():
    privs = [ted.PrivKey.generate(bytes([i + 1]) * 32) for i in range(4)]
    genesis = GenesisDoc(
        chain_id=CHAIN, genesis_time=Timestamp(1_700_000_000, 0),
        validators=[GenesisValidator(pub_key=p.pub_key(), power=10)
                    for p in privs])
    verifier = votestream.StreamingVerifier(device="cpu")
    verifier.start()
    nodes = [P2PNode(p, genesis, i, verifier) for i, p in enumerate(privs)]
    late = None
    received = {i: [] for i in range(4)}
    for i, n in enumerate(nodes):
        recv = n.mempool_reactor.receive

        def spy(env, i=i, recv=recv):
            received[i].extend(tmr.decode_txs(env.message))
            return recv(env)
        n.mempool_reactor.receive = spy
    try:
        for n in nodes:
            n.sw.start()
        for i, a in enumerate(nodes):
            for b in nodes[i + 1:]:
                _dial(b, a)
        assert all(n.sw.peers.size() == 3 for n in nodes)
        # the transaction goes to one node's mempool only
        src = 2
        nodes[src].mempool.check_tx(b"gossip=works")
        _wait(lambda: min(n.cs.height for n in nodes) > 3, "height 3",
              nodes=nodes)
        _wait(lambda: all(n.app.kv.get("gossip") == "works" for n in nodes),
              "the tx committed everywhere", nodes=nodes)
        assert all(b"gossip=works" in received[i]
                   for i in range(4) if i != src)
        top = min(n.bstore.height() for n in nodes)
        for h in range(1, top + 1):
            assert len({n.bstore.load_block(h).hash() for n in nodes}) == 1
        txs = [tx for h in range(1, top + 1)
               for tx in nodes[0].bstore.load_block(h).data.txs]
        assert txs.count(b"gossip=works") == 1
        assert all(n.evidence.error is None for n in nodes)
        # a fifth, non-validator node catches up by block sync over TCP
        late = P2PNode(None, genesis, 4, verifier, block_sync=True)
        late.sw.start()
        for n in nodes:
            _dial(late, n)
        assert late.blocksync.wait_synced(TIMEOUT_S)
        assert late.blocksync.error is None
        synced = late.bstore.height()
        assert synced >= top - 1
        for h in range(1, min(synced, nodes[0].bstore.height()) + 1):
            assert late.bstore.load_block(h).hash() == \
                nodes[0].bstore.load_block(h).hash()
        # the joiner's stored state against the validators' next header
        st = late.sstore.load()
        _wait(lambda: nodes[0].bstore.height() > st.last_block_height,
              "the validators' next block", nodes=nodes)
        assert st.app_hash == nodes[0].bstore.load_block(
            st.last_block_height + 1).header.app_hash
    finally:
        for n in nodes + ([late] if late is not None else []):
            n.stop()
        verifier.stop()
