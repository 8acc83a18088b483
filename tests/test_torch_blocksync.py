"""Block sync in the port (blocksync/: messages, BlockPool,
BlocksyncReactor) against the JAX package on the CPU.

The wire messages are compared byte for byte; the pools are fed the same
operations and compared; the reactor syncs a fresh port node from
serving port reactors that hold the chain the JAX package built
(test_torch_execution.build_chain: 12 blocks, 4 validators, a fifth
joining at height 7), serial and pipelined, and must reach the JAX
chain's app hash with every stored block byte-identical; a lying peer
(one flipped signature byte in the LastCommit it serves) must be stopped
and blamed for the tampered height.  Reactors are joined by an
in-process loopback double (Net, below; test_torch_consensus.py joins
its consensus reactors with it too): every message crosses it as wire
bytes, delivered to the receiving node's reactor for the channel on
that node's thread.  The port runs on device="cpu"; one sync sends its windows
through the plain RLC program (K1-K4) by lowering
DeferredSigBatch.DEVICE_THRESHOLD."""

import gc
import queue
import random
import threading
import time
import types

import pytest
import torch

from cometbft_tpu.blocksync import messages as jbm
from cometbft_tpu.blocksync import pool as jpool
from cometbft_tpu_torch.blocksync import messages as tbm
from cometbft_tpu_torch.blocksync import pool as tpool
from cometbft_tpu_torch.blocksync import reactor as treactor
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import sigcache
from cometbft_tpu_torch.libs import lockrank as plr
from cometbft_tpu_torch.ops import (_build, cuda_decompress, cuda_msm,
                                    cuda_persig)
from cometbft_tpu_torch.p2p.base_reactor import Envelope
from cometbft_tpu_torch.types import validation as tval
from test_torch_execution import (JAX, N_BLOCKS, PORT, build_chain,
                                  chain_spec, genesis_of, node)

TOP = N_BLOCKS                  # the serving peers' tip
TARGET = TOP - 1                # a syncer stops one block behind it
# the liar's tampered commit height.  Its 12 blocks are released at
# once: the first window stops at the validator-set change (1..6), the
# second is 7..12 with 5 usable, quantized to 4 (7..10), so the tampered
# block 11 is that window's next block and commit 10 fails the signature
# check.  (A tampered block inside a window fails its block ID check
# first, and is blamed on its own height.)
BAD = 10
SYNC_TIMEOUT_S = 120.0


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
def _checks(monkeypatch):
    """Lock ranks in raise mode, the port's verdict cache on and empty
    (as a node runs), no thread left behind, quick hand-off polls."""
    monkeypatch.setattr(treactor, "SWITCH_TO_CONSENSUS_INTERVAL", 0.05)
    plr.enable("raise")
    baseline = set(threading.enumerate())
    sigcache.reset()
    yield
    sigcache.reset()
    sigcache.set_enabled(None)
    assert plr.violations() == []
    plr.disable()
    assert plr.leaked_threads(baseline, grace_s=2.0) == []


@pytest.fixture(scope="module")
def chain():
    return build_chain(JAX, chain_spec())


# -- the loopback double ---------------------------------------------------------

class _Peer:
    """A node's handle on a remote node: try_send (and send, which never
    blocks here) hands an Envelope to the remote node's reactor for the
    channel, on the remote node's thread; set / get keep per-peer data
    (the consensus reactor's PeerState)."""

    def __init__(self, local, remote):
        self.id = remote.name
        self.local, self.remote = local, remote
        self.open = True
        self.data = {}

    def try_send(self, ch, msg, tctx=None):
        back = self.remote.peers.get(self.local.name)
        if not self.open or back is None:     # disconnected meanwhile
            return False
        self.remote.inbox.put(Envelope(src=back, message=bytes(msg),
                                       channel_id=ch, tctx=tctx))
        return True

    def send(self, ch, msg, tctx=None):
        return self.try_send(ch, msg, tctx)

    def set(self, key, value):
        self.data[key] = value

    def get(self, key):
        return self.data.get(key)


class _Switch:
    """The switch surface the reactor reads: peers.get / peers.list,
    try_broadcast and stop_peer_for_error (which drops the peer on both
    sides and records why)."""

    def __init__(self, node):
        self.node = node
        self.peers = self
        self.stopped = []

    def get(self, peer_id):
        return self.node.peers.get(peer_id)

    def list(self):
        return list(self.node.peers.values())

    def try_broadcast(self, ch, msg):
        for p in self.list():
            p.try_send(ch, msg)

    def stop_peer_for_error(self, peer, reason):
        self.stopped.append((peer.id, reason))
        self.node.net.disconnect(self.node, peer.remote, reason)


class _Node:
    """A node's reactors (the first is `reactor`), each receiving the
    channels it declares; a delivery thread."""

    def __init__(self, net, name, *reactors):
        self.net, self.name = net, name
        self.reactor, self.reactors = reactors[0], reactors
        self.by_channel = {d.id: r for r in reactors
                           for d in r.get_channels()}
        self.peers = {}
        self.inbox = queue.Queue()
        self.held = None          # a list while deliveries are held
        self.switch = _Switch(self)
        for r in reactors:
            r.set_switch(self.switch)
        self.thread = threading.Thread(target=self._deliver,
                                       name=f"loop-{name}", daemon=True)
        self.thread.start()

    def _deliver(self):
        while True:
            env = self.inbox.get()
            if env is None:
                return
            if env is _RELEASE:
                held, self.held = self.held, None
                for e in sorted(held, key=_descending):
                    if e.src.open:
                        self._receive(e)
            elif self.held is not None and _descending(env) < 0:
                self.held.append(env)
            elif env.src.open:
                self._receive(env)

    def _receive(self, env):
        self.by_channel.get(env.channel_id, self.reactor).receive(env)

    def hold(self):
        """Queue the blocks sent to this node instead of delivering them
        (call before connecting it)."""
        self.held = []

    def release(self, n_blocks):
        """Once n_blocks blocks are held, deliver them in descending
        height order (the lowest lands last, so the sync routine sees
        them all at once), then deliver as usual."""
        _wait(lambda: len(self.held) >= n_blocks, f"{n_blocks} held blocks")
        self.inbox.put(_RELEASE)


_RELEASE = object()


def _descending(env):
    """Sort key: blocks by descending height, then everything else."""
    m = tbm.unwrap(env.message)
    return -m.block.header.height if isinstance(m, tbm.BlockResponse) \
        and m.block is not None else 1


class Net:
    """Reactors joined all to all in one process."""

    def __init__(self):
        self.nodes = {}

    def add(self, name, *reactors):
        self.nodes[name] = _Node(self, name, *reactors)
        return self.nodes[name]

    def connect(self, a, b):
        a, b = self.nodes[a], self.nodes[b]
        a.peers[b.name] = _Peer(a, b)
        b.peers[a.name] = _Peer(b, a)
        for x, y in ((a, b), (b, a)):
            for r in x.reactors:
                r.init_peer(x.peers[y.name])
        for x, y in ((a, b), (b, a)):
            for r in x.reactors:
                r.add_peer(x.peers[y.name])

    def connect_all(self):
        names = list(self.nodes)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                self.connect(a, b)

    def disconnect(self, a, b, reason):
        for x, y in ((a, b), (b, a)):
            p = x.peers.pop(y.name, None)
            if p is not None:
                p.open = False
                for r in x.reactors:
                    r.remove_peer(p, reason)

    def close(self):
        for n in self.nodes.values():
            for r in n.reactors:
                r.stop()
            n.inbox.put(None)
        for n in self.nodes.values():
            n.thread.join(5)


# -- serving and syncing nodes -------------------------------------------------------

def _port_block(jblock):
    return PORT.block.Block.from_proto(jblock.to_proto())


def serving_reactor(chain, tamper_at=None):
    """A port reactor serving the JAX-built chain from a port BlockStore;
    with tamper_at, the LastCommit of block tamper_at + 1 carries its
    first signature with one byte flipped."""
    n = node(PORT, genesis_of(PORT, chain_spec()))
    for h, jb in enumerate(chain.blocks, start=1):
        b = _port_block(jb)
        if tamper_at is not None and h == tamper_at + 1:
            sigs = list(b.last_commit.signatures)
            s = sigs[0]
            sigs[0] = type(s)(s.block_id_flag, s.validator_address,
                              s.timestamp, bytes([s.signature[0] ^ 1])
                              + s.signature[1:])
            b.last_commit = PORT.block.Commit(
                b.last_commit.height, b.last_commit.round,
                b.last_commit.block_id, sigs)
        parts = PORT.ps.PartSet.from_data(b.to_proto())
        seen = PORT.block.Commit.from_proto(
            chain.bstore.load_seen_commit(h).to_proto())
        n.bstore.save_block(b, parts, seen)
    return treactor.BlocksyncReactor(n.state, n.exe, n.bstore, False,
                                     device="cpu")


def syncing_node(depth):
    n = node(PORT, genesis_of(PORT, chain_spec()))
    n.reactor = treactor.BlocksyncReactor(n.state, n.exe, n.bstore, True,
                                          device="cpu", pipeline_depth=depth)
    n.blamed = []
    redo = n.reactor.pool.redo_request

    def blame(height):
        n.blamed.append(height)
        return redo(height)

    n.reactor.pool.redo_request = blame
    return n


def _wait(cond, what):
    deadline = time.monotonic() + SYNC_TIMEOUT_S
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def sync(chain, depth, liar=False, me=None):
    """A fresh node (or `me`) synced from two honest serving reactors
    (and, with liar, a third one that lies, connected alone first).
    Raises what stopped the sync, if anything did."""
    net = Net()
    me = me or syncing_node(depth)
    me.stopped = []
    try:
        net.add("me", me.reactor)
        names = ["honest-a", "honest-b"]
        for name in names:
            net.add(name, serving_reactor(chain)).reactor.start()
        if liar:
            net.add("liar", serving_reactor(chain, BAD)).reactor.start()
        me.reactor.start()
        if liar:
            net.nodes["me"].hold()
            net.connect("me", "liar")
            net.nodes["me"].release(TOP)
            _wait(lambda: net.nodes["me"].switch.stopped, "the liar's stop")
        for name in names:
            net.connect("me", name)
        try:
            assert me.reactor.wait_synced(SYNC_TIMEOUT_S), \
                "timed out waiting for the sync"
        finally:
            me.stopped = list(net.nodes["me"].switch.stopped)
    finally:
        net.close()
    return me


def _check_synced(me, chain):
    assert me.reactor.state.last_block_height == TARGET
    assert me.reactor.state.app_hash == chain.blocks[TARGET].header.app_hash
    assert me.sstore.load().to_proto() == me.reactor.state.to_proto()
    assert me.bstore.height() == TARGET and me.bstore.base() == 1
    for h in range(1, TARGET + 1):
        assert me.bstore.load_block_bytes(h) == chain.blocks[h - 1].to_proto()
        assert me.bstore.load_block(h).hash() == chain.blocks[h - 1].hash()
    assert me.app.app_hash == chain.blocks[TARGET].header.app_hash


@pytest.mark.parametrize("depth", [1, 2])
def test_sync_reaches_the_jax_chain(chain, depth):
    me = sync(chain, depth)
    _check_synced(me, chain)
    assert me.stopped == [] and me.blamed == []


def test_lying_peer_is_stopped_and_blamed(chain, monkeypatch):
    """The window whose next block is the liar's fails its RLC program
    (plain K1-K4, thresholds at 2) and is localized once by the plain
    per-signature program (K1 + K14) over its live signatures: the new
    set's 4 of 5 a commit, 4 commits."""
    monkeypatch.setattr(tval.DeferredSigBatch, "DEVICE_THRESHOLD", 2)
    monkeypatch.setattr(tbatch, "DEVICE_THRESHOLD", 2)
    widths = []
    plain = cuda_persig.verify_ladder_plain

    def k14(pts, oks, s_limbs, h_limbs, return_acc=False):
        widths.append(s_limbs.shape[-1])
        return plain(pts, oks, s_limbs, h_limbs, return_acc)

    monkeypatch.setattr(cuda_persig, "verify_ladder_plain", k14)
    me = sync(chain, 1, liar=True)
    _check_synced(me, chain)
    assert me.stopped == [("liar", "served invalid block")]
    assert me.blamed == [BAD]
    assert widths == [4 * 4]


def test_windows_run_the_plain_rlc_program(chain, monkeypatch):
    """With the thresholds at 2 every window of two signatures and more
    goes through MixedBatchVerifier: the plain versions of K1-K4, one
    RLC program (one K4) a window."""
    monkeypatch.setattr(tval.DeferredSigBatch, "DEVICE_THRESHOLD", 2)
    monkeypatch.setattr(tbatch, "DEVICE_THRESHOLD", 2)
    calls = {"k1": 0, "k4": 0}
    plain_k1, plain_k4 = cuda_decompress.decompress_plain, \
        cuda_msm.fold_verify_plain

    def k1(*a):
        calls["k1"] += 1
        return plain_k1(*a)

    def k4(*a):
        calls["k4"] += 1
        return plain_k4(*a)

    monkeypatch.setattr(cuda_decompress, "decompress_plain", k1)
    monkeypatch.setattr(cuda_msm, "fold_verify_plain", k4)
    windows = []
    verify = tval.DeferredSigBatch.verify

    def spy(self, device="cuda"):
        n, k1_0, k4_0 = self.count(), calls["k1"], calls["k4"]
        try:
            return verify(self, device=device)
        finally:
            windows.append((n, calls["k1"] - k1_0, calls["k4"] - k4_0))

    monkeypatch.setattr(tval.DeferredSigBatch, "verify", spy)
    me = sync(chain, 1)
    _check_synced(me, chain)
    assert windows and all(n >= 2 for n, _, _ in windows)
    # a window's program decompresses its keys and R points (K1 twice)
    assert all((k1, k4) == (2, 1) for _, k1, k4 in windows), windows


@pytest.mark.parametrize("depth", [1, 2])
def test_kernel_build_error_stops_the_sync_and_blames_no_peer(
        chain, depth, monkeypatch):
    """A kernel that does not build is no peer's fault: the window's
    verify raises KernelBuildError (serial inline, pipelined through the
    window's handle), the sync stops with it in .error, wait_synced
    raises it, no block is applied and no peer is stopped or blamed."""
    monkeypatch.setattr(tval.DeferredSigBatch, "DEVICE_THRESHOLD", 2)
    monkeypatch.setattr(tbatch, "DEVICE_THRESHOLD", 2)
    calls = []

    def no_build(*a, **k):
        calls.append(1)
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(tbatch, "_device_verify", no_build)
    monkeypatch.setattr(tbatch, "_device_verify_hash", no_build)
    me = syncing_node(depth)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        sync(chain, depth, me=me)
    assert calls
    assert isinstance(me.reactor.error, _build.KernelBuildError)
    assert not me.reactor.synced
    assert me.stopped == [] and me.blamed == []
    assert me.reactor.state.last_block_height == 0
    assert me.bstore.height() == 0


def test_reactor_device_rules():
    n = node(PORT, genesis_of(PORT, chain_spec()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            treactor.BlocksyncReactor(n.state, n.exe, n.bstore, True)
    n.exe.device = torch.device("meta")
    with pytest.raises(ValueError, match="the executor runs on meta"):
        treactor.BlocksyncReactor(n.state, n.exe, n.bstore, True,
                                  device="cpu")


# -- wire messages ----------------------------------------------------------

def _messages(bm, block, ext):
    return [bm.BlockRequest(7), bm.BlockRequest(0), bm.NoBlockResponse(9),
            bm.StatusRequest(), bm.StatusResponse(12, 1),
            bm.StatusResponse(0, 0), bm.BlockResponse(block),
            bm.BlockResponse(block, ext), bm.BlockResponse()]


@pytest.mark.parametrize("i", range(9))
def test_messages_equal_jax(chain, i):
    jb = chain.blocks[5]
    jext = chain.bstore.load_seen_commit(6)
    jext = JAX.block.ExtendedCommit(
        height=jext.height, round=jext.round, block_id=jext.block_id,
        extended_signatures=[JAX.block.ExtendedCommitSig(
            s.block_id_flag, s.validator_address, s.timestamp, s.signature)
            for s in jext.signatures])
    tb = _port_block(jb)
    text = PORT.block.ExtendedCommit.from_proto(jext.to_proto())
    j = _messages(jbm, jb, jext)[i]
    t = _messages(tbm, tb, text)[i]
    wire = jbm.wrap(j)
    assert tbm.wrap(t) == wire
    back = tbm.unwrap(wire)
    assert type(back).__name__ == type(j).__name__
    assert tbm.wrap(back) == wire
    if isinstance(t, tbm.BlockResponse) and t.block is not None:
        raw = tb.to_proto()
        assert tbm.wrap_block_response_bytes(raw, t.ext_commit) == wire
        assert jbm.wrap_block_response_bytes(raw, j.ext_commit) == wire


def test_unwrap_refuses_as_jax():
    for payload in (b"", b"\x08\x01", b"\x32\x00"):
        with pytest.raises(ValueError) as je:
            jbm.unwrap(payload)
        with pytest.raises(ValueError) as te:
            tbm.unwrap(payload)
        assert str(te.value) == str(je.value)


# -- the pool -------------------------------------------------------------------

class _Blk:
    def __init__(self, h):
        self.header = types.SimpleNamespace(height=h)


def _pools(**kw):
    """A JAX and a port pool fed the same calls; their sends and peer
    errors are recorded."""
    out = []
    for mod in (jpool, tpool):
        log = {"sent": [], "errors": []}
        p = mod.BlockPool(
            1, lambda h, pid, log=log: log["sent"].append((h, pid)),
            lambda pid, r, log=log: log["errors"].append((pid, r)), **kw)
        p.log = log
        out.append(p)
    return out


def _fill(p, mod, peer_of):
    """Requesters 1..len(peer_of) assigned as peer_of says, blocks of
    the heights in peer_of delivered."""
    for h, pid in enumerate(peer_of, start=1):
        r = mod._Requester(h)
        p._requesters[h] = r
        if pid:
            r.peer_id = pid
            p._peers[pid].num_pending += 1


def _state(p):
    return ({h: (r.peer_id, r.block is not None, sorted(r.excluded))
             for h, r in sorted(p._requesters.items())},
            {pid: (q.base, q.height, q.num_pending)
             for pid, q in sorted(p._peers.items())},
            p.height, p.log)


def test_pool_peek_window_offsets_equal_jax():
    pools = _pools()
    for p, mod in zip(pools, (jpool, tpool)):
        p.set_peer_range("a", 1, 20)
        p.set_peer_range("b", 1, 20)
        _fill(p, mod, ["a", "b"] * 5)
        for h in (1, 2, 3, 4, 6, 7, 8, 9):
            p.add_block(p._requesters[h].peer_id, _Blk(h), None)
    got = []
    for p in pools:
        rows = []
        for max_blocks in (1, 2, 3, 8):
            for offset in range(0, 10):
                win, after = p.peek_window(max_blocks, offset)
                rows.append(([b.header.height for b, _ in win],
                             after.header.height if after else None))
        got.append(rows)
    assert got[0] == got[1]
    assert got[1][3] == ([4], None) and got[1][30] == ([1, 2, 3, 4], None)


def test_pool_redo_remove_and_unsolicited_equal_jax():
    pools = _pools(retry_jitter=0)
    out = []
    for p, mod in zip(pools, (jpool, tpool)):
        for pid in "abc":
            p.set_peer_range(pid, 1, 10)
        _fill(p, mod, ["a", "b", "c", "a", "b", "c"])
        for h in (1, 2, 3, 4):
            p.add_block(p._requesters[h].peer_id, _Blk(h), None)
        p.add_block("c", _Blk(5), None)             # not c's height
        p.add_block("a", _Blk(99), None)            # no requester
        bad = p.redo_request(2)
        p.remove_peer("c")
        p.pop_request()
        p.set_peer_range("d", 2, 30)
        out.append((bad, _state(p), p.max_peer_height(), p.is_caught_up()))
    assert out[0] == out[1]
    bad, (reqs, peers, height, log), _, _ = out[1]
    assert bad == ["b", "c"] and height == 2
    assert log["errors"] == [("c", "unsolicited block at height 5"),
                             ("a", "unsolicited block at height 99")]
    assert "b" not in peers and "c" not in peers and reqs[6][0] is None


def test_pool_caught_up_and_timeouts_equal_jax():
    """Started pools with a 0.1 s peer timeout and a sender that never
    answers: each side requests from its one peer, times it out, drops
    it and reports why; random is seeded alike for both."""
    results = []
    for mod in (jpool, tpool):
        random.seed(5)
        log = {"sent": [], "errors": []}
        p = mod.BlockPool(3, lambda h, pid: log["sent"].append((h, pid)),
                          lambda pid, r: log["errors"].append((pid, r)),
                          peer_timeout=0.1, retry_jitter=0)
        assert not p.is_caught_up()
        p.set_peer_range("slow", 1, 4)
        p.start()
        try:
            _wait(lambda: log["errors"], "the timeout")
        finally:
            p.stop()
            time.sleep(0.05)
        results.append((sorted(set(log["sent"])), log["errors"][:1],
                        p._peers, p.is_caught_up()))
    assert results[0] == results[1]
    assert results[1][0] == [(3, "slow"), (4, "slow")]
    assert results[1][1] == [("slow", "blocksync request timeout")]
    caught = tpool.BlockPool(5, lambda *a: None)
    caught.set_peer_range("a", 1, 5)
    assert caught.is_caught_up()
