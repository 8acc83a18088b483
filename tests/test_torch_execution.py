"""Block execution in the port (state/, store/, abci/, apps/kvstore.py,
types/params.py, types/genesis.py) held against the JAX package byte for
byte on the CPU.

The same 12-block chain is built by both packages from one numpy seed:
4 validators, a kvstore `val:` transaction at height VAL_AT that adds a
fifth validator whose key the test holds (the set changes at
VAL_AT + 2), proposals from each package's own
BlockExecutor.create_proposal_block over a reap double, every validator
signing the canonical precommit with one timestamp a height.  Block
hashes, part-set headers, app hashes, State proto bytes, FinalizeBlock
responses and the block and state stores' bytes must agree at every
height.  The port runs on device="cpu" (its commits of 4-5 signatures
stay on the host loop, under the batch thresholds); the JAX package runs
its host verifiers (COMETBFT_TPU_PROVIDER=cpu around its calls)."""

import base64
import contextlib
import dataclasses
import gc
import importlib
import os
import types
import typing

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import sigcache

CHAIN = "exec-chain"
T0 = 1_700_000_000
N_BLOCKS = 12
N_VALS = 4
VAL_AT = 5
SEED = 20261018

_MODULES = dict(
    at="abci.types", client="abci.client", kv="apps.kvstore",
    ed="crypto.ed25519", canonical="types.canonical", block="types.block",
    genesis="types.genesis", params="types.params", ps="types.part_set",
    ts="types.timestamp", state="state.state", sstore="state.store",
    exe="state.execution", sval="state.validation",
    bstore="store.blockstore", kvdb="store.kv", val="types.validation")


def side(pkg: str) -> types.SimpleNamespace:
    """The modules of one package under common names."""
    ns = types.SimpleNamespace(
        **{k: importlib.import_module(f"{pkg}.{m}")
           for k, m in _MODULES.items()})
    ns.port = pkg == "cometbft_tpu_torch"
    ns.kw = {"device": "cpu"} if ns.port else {}
    return ns


JAX = side("cometbft_tpu")
PORT = side("cometbft_tpu_torch")


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
def _port_cache():
    sigcache.reset()
    yield
    sigcache.reset()
    sigcache.set_enabled(None)


@contextlib.contextmanager
def host_side(ns):
    """The JAX package's calls run its host verifiers; the port's run
    as they are (its variable would send windows to the host loop)."""
    if ns.port:
        yield
        return
    prev = os.environ.get("COMETBFT_TPU_PROVIDER")
    os.environ["COMETBFT_TPU_PROVIDER"] = "cpu"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("COMETBFT_TPU_PROVIDER")
        else:
            os.environ["COMETBFT_TPU_PROVIDER"] = prev


# -- the chain -----------------------------------------------------------------

class Reap:
    """The mempool seam of build_chain: reap returns the height's
    transactions, the rest does nothing."""

    def __init__(self):
        self.txs = []

    def reap_max_bytes_max_gas(self, max_bytes, max_gas):
        return list(self.txs)

    def pre_update(self):
        pass

    def lock(self):
        pass

    def unlock(self):
        pass

    def flush_app_conn(self):
        pass

    def update(self, *a, **k):
        pass


def chain_spec(seed=SEED, n_blocks=N_BLOCKS, n_vals=N_VALS, val_at=VAL_AT):
    """Key seeds (the last one the joiner's) and each height's
    transactions, from one numpy seed."""
    rng = np.random.default_rng(seed)
    keys = [rng.bytes(32) for _ in range(n_vals + 1)]
    ntx = [int(rng.integers(0, 4)) for _ in range(n_blocks)]
    txs = {h: [f"sim{h}x{t}=v{h}".encode() for t in range(ntx[h - 1])]
           for h in range(1, n_blocks + 1)}
    return {"keys": keys, "txs": txs, "val_at": val_at,
            "n_blocks": n_blocks}


def genesis_of(ns, spec):
    privs = [ns.ed.PrivKey.generate(k) for k in spec["keys"][:-1]]
    return ns.genesis.GenesisDoc(
        chain_id=CHAIN, genesis_time=ns.ts.Timestamp(T0, 0),
        validators=[ns.genesis.GenesisValidator(pub_key=p.pub_key(),
                                                power=10) for p in privs])


def node(ns, gdoc):
    """Fresh stores, a kvstore app after InitChain and an executor."""
    state = ns.state.make_genesis_state(gdoc)
    n = types.SimpleNamespace(state_db=ns.kvdb.MemDB(),
                              block_db=ns.kvdb.MemDB(), reap=Reap())
    n.sstore = ns.sstore.StateStore(n.state_db)
    n.sstore.bootstrap(state)
    n.bstore = ns.bstore.BlockStore(n.block_db)
    n.app = ns.kv.KVStoreApplication()
    n.client = ns.client.LocalClient(n.app)
    n.client.init_chain(ns.at.InitChainRequest(
        chain_id=gdoc.chain_id, initial_height=state.initial_height))
    n.exe = ns.exe.BlockExecutor(n.sstore, n.client, n.reap, **ns.kw)
    n.state = state
    return n


def build_chain(ns, spec, on_height=None):
    """Grow the chain through ns's own executor (the JAX package's
    simnet/node.py grow_chain, with a reap double); on_height(h, n,
    block, parts) runs after each height is stored and applied."""
    privs = [ns.ed.PrivKey.generate(k) for k in spec["keys"]]
    by_addr = {p.pub_key().address(): p for p in privs}
    gdoc = genesis_of(ns, spec)
    with host_side(ns):
        n = node(ns, gdoc)
        n.genesis, n.blocks, n.privs = gdoc, [], privs
        last_ext = ns.block.ExtendedCommit()
        for h in range(1, spec["n_blocks"] + 1):
            txs = list(spec["txs"][h])
            if h == spec["val_at"]:
                txs.append(b"val:" + base64.b64encode(
                    privs[-1].pub_key().bytes()) + b"!10")
            n.reap.txs = txs
            state = n.state
            block = n.exe.create_proposal_block(
                h, state, last_ext, state.validators.get_proposer().address)
            parts = ns.ps.PartSet.from_data(block.to_proto())
            bid = ns.block.BlockID(block.hash(), parts.header)
            ts = block.header.time.add_ns(1_000_000_000)
            sigs = []
            for v in state.validators.validators:
                sb = ns.canonical.vote_sign_bytes(
                    CHAIN, ns.canonical.PRECOMMIT, h, 0, bid, ts)
                sigs.append(ns.block.ExtendedCommitSig(
                    ns.block.BLOCK_ID_FLAG_COMMIT, v.address, ts,
                    by_addr[v.address].sign(sb)))
            last_ext = ns.block.ExtendedCommit(
                height=h, round=0, block_id=bid, extended_signatures=sigs)
            n.bstore.save_block(block, parts, last_ext.to_commit())
            n.state = n.exe.apply_block(state, bid, block)
            n.blocks.append(block)
            if on_height is not None:
                on_height(h, n, block, parts)
    return n


def _record(rows):
    def on_height(h, n, block, parts):
        rows.append({
            "block_hash": block.hash(), "parts": parts.header.to_proto(),
            "block_bytes": n.bstore.load_block_bytes(h),
            "app_hash": n.state.app_hash,
            "state": n.state.to_proto(),
            "stored_state": n.sstore.load().to_proto(),
            "fb_response": n.sstore.load_finalize_block_response(h),
            "validators": n.sstore.load_validators(h + 1).to_proto(),
            "params": n.sstore.load_consensus_params(h + 1).to_proto(),
            "block_db": list(n.block_db.iterate()),
            "state_db": list(n.state_db.iterate()),
            "app": (n.app.height, n.app.app_hash, dict(n.app.kv),
                    dict(n.app.validator_updates))})
    return on_height


@pytest.fixture(scope="module")
def chains():
    spec = chain_spec()
    jrows, trows = [], []
    j = build_chain(JAX, spec, _record(jrows))
    t = build_chain(PORT, spec, _record(trows))
    return spec, j, t, jrows, trows


@pytest.mark.parametrize("h", range(1, N_BLOCKS + 1))
def test_chain_equal_at_every_height(chains, h):
    _, _, _, jrows, trows = chains
    j, t = jrows[h - 1], trows[h - 1]
    assert j.keys() == t.keys()
    for k in j:
        assert t[k] == j[k], f"height {h}: {k} differs"


def test_chain_changes_its_validator_set(chains):
    spec, j, t, _, _ = chains
    n0, n1 = N_VALS, N_VALS + 1
    for n in (j, t):
        sizes = [b.header.validators_hash for b in n.blocks]
        assert len(set(sizes)) == 2
        first_new = sizes.index(sizes[-1]) + 1
        assert first_new == spec["val_at"] + 2
        assert n.state.validators.size() == n1
        assert n.blocks[0].last_commit.size() == 0
        assert n.blocks[first_new].last_commit.size() == n1
        assert n.blocks[first_new - 1].last_commit.size() == n0
    assert t.state.app_hash == j.state.app_hash == \
        (sum(len(v) for v in spec["txs"].values()) + 1).to_bytes(8, "big")


def _tampered(ns, n, kind):
    """Block VAL_AT + 3 of chain n, with one field made wrong, and the
    state it validates against."""
    h = VAL_AT + 3
    block = ns.block.Block.from_proto(n.blocks[h - 1].to_proto())
    state = _state_before(ns, n, h)
    if kind == "app_hash":
        block.header.app_hash = b"\x07" * 8
    elif kind == "validators_hash":
        block.header.validators_hash = bytes(32)
    else:
        sigs = list(block.last_commit.signatures)
        s = sigs[1]
        sigs[1] = type(s)(s.block_id_flag, s.validator_address, s.timestamp,
                          s.signature[:5] + bytes([s.signature[5] ^ 1])
                          + s.signature[6:])
        block.last_commit = ns.block.Commit(
            block.last_commit.height, block.last_commit.round,
            block.last_commit.block_id, sigs)
        block.header.last_commit_hash = block.last_commit.hash()
    return state, block


def _state_before(ns, n, h):
    """The state after height h - 1, rebuilt from the stored history:
    the chain is replayed into a fresh node up to h - 1."""
    m = node(ns, n.genesis)
    for k in range(1, h):
        b = ns.block.Block.from_proto(n.blocks[k - 1].to_proto())
        parts = ns.ps.PartSet.from_data(b.to_proto())
        m.state = m.exe.apply_block(m.state,
                                    ns.block.BlockID(b.hash(), parts.header),
                                    b)
    return m.state


@pytest.mark.parametrize("kind", ["app_hash", "validators_hash",
                                  "last_commit"])
def test_validate_block_refusals_match_jax(chains, kind):
    _, j, t, _, _ = chains
    errs = []
    for ns, n in ((JAX, j), (PORT, t)):
        with host_side(ns):
            state, block = _tampered(ns, n, kind)
            with pytest.raises(Exception) as e:
                ns.sval.validate_block(state, block, **ns.kw)
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1]
    assert errs[1][0] == {"app_hash": "InvalidBlockError",
                          "validators_hash": "InvalidBlockError",
                          "last_commit": "ErrInvalidSignature"}[kind]


def test_replay_from_stores_reaches_the_same_app_hash(chains):
    """A second port node applies the JAX-built blocks through its own
    executor (validate_block with every LastCommit checked)."""
    _, j, _, _, _ = chains
    m = node(PORT, genesis_of(PORT, chain_spec()))
    for jb in j.blocks:
        b = PORT.block.Block.from_proto(jb.to_proto())
        parts = PORT.ps.PartSet.from_data(b.to_proto())
        bid = PORT.block.BlockID(b.hash(), parts.header)
        m.bstore.save_block(b, parts, None)
        m.state = m.exe.apply_block(m.state, bid, b)
    assert m.state.app_hash == j.state.app_hash
    assert m.state.to_proto() == j.state.to_proto()


def test_executor_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    n = node(PORT, genesis_of(PORT, chain_spec()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.exe.BlockExecutor(n.sstore, n.client)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.sval.validate_block(n.state, PORT.block.Block())


# -- params, genesis, ABCI messages ------------------------------------------

def _params(ns, case):
    p = ns.params
    if case == "default":
        return p.ConsensusParams()
    if case == "custom":
        return p.ConsensusParams(
            block=p.BlockParams(max_bytes=22020096, max_gas=1000),
            evidence=p.EvidenceParams(10, 3600 * 10**9 + 7, 50000),
            validator=p.ValidatorParams(["ed25519", "secp256k1"]),
            version=p.VersionParams(app=3),
            synchrony=p.SynchronyParams(10**8, 2 * 10**9),
            feature=p.FeatureParams(5, 9))
    if case == "bad_block":
        return p.ConsensusParams(block=p.BlockParams(max_bytes=0))
    if case == "bad_keys":
        return p.ConsensusParams(validator=p.ValidatorParams(["rsa"]))
    if case == "bad_evidence":
        return p.ConsensusParams(
            block=p.BlockParams(max_bytes=100),
            evidence=p.EvidenceParams(max_bytes=1000))
    raise ValueError(case)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:                          # noqa: BLE001
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("case", ["default", "custom", "bad_block",
                                  "bad_keys", "bad_evidence"])
def test_consensus_params_equal_jax(case):
    j, t = _params(JAX, case), _params(PORT, case)
    assert t.to_proto() == j.to_proto() and t.hash() == j.hash()
    assert PORT.params.ConsensusParams.from_proto(j.to_proto()) == t
    assert _outcome(t.validate) == _outcome(j.validate)
    assert [t.vote_extensions_enabled(h) for h in range(12)] == \
        [j.vote_extensions_enabled(h) for h in range(12)]
    blk = JAX.params.BlockParams(1024, 5).to_proto()
    upd = bytes([0x0A, len(blk)]) + blk     # a block-params-only update
    assert t.merge_proto_updates(upd).to_proto() == \
        j.merge_proto_updates(upd).to_proto()


def _genesis(ns, case):
    gdoc = genesis_of(ns, chain_spec())
    gdoc.app_state = {"k": [1, 2]}
    if case == "no_chain":
        gdoc.chain_id = ""
    elif case == "long_chain":
        gdoc.chain_id = "c" * 51
    elif case == "zero_power":
        gdoc.validators[2].power = 0
    elif case == "bad_address":
        gdoc.validators[1].address = bytes(20)
    elif case == "height_zero":
        gdoc.initial_height = 0
    return gdoc


@pytest.mark.parametrize("case", ["ok", "no_chain", "long_chain",
                                  "zero_power", "bad_address",
                                  "height_zero"])
def test_genesis_equal_jax(case):
    j, t = _genesis(JAX, case), _genesis(PORT, case)
    assert _outcome(t.validate_and_complete) == \
        _outcome(j.validate_and_complete)
    assert t.to_json() == j.to_json() and t.hash() == j.hash()
    if case in ("ok", "height_zero"):
        back = PORT.genesis.GenesisDoc.from_json(j.to_json())
        assert back.to_json() == j.to_json()
        assert back.validator_hash(device="cpu") == j.validator_hash()
        assert PORT.state.make_genesis_state(back).to_proto() == \
            JAX.state.make_genesis_state(
                JAX.genesis.GenesisDoc.from_json(j.to_json())).to_proto()


_LIST_ITEMS = {"attributes": "EventAttribute", "misbehavior": "Misbehavior",
               "validators": "ValidatorUpdate", "events": "Event",
               "tx_results": "ExecTxResult", "snapshots": "Snapshot",
               "validator_updates": "ValidatorUpdate"}


def _sample(at, cls, depth=0):
    """An instance of ABCI message cls with every field set."""
    hints = typing.get_type_hints(cls, vars(at))
    kw = {}
    for i, f in enumerate(dataclasses.fields(cls)):
        hint = hints[f.name]
        name = f"{cls.__name__}.{f.name}"
        if hint is int:
            kw[f.name] = 3 + i
        elif hint is bool:
            kw[f.name] = True
        elif hint is str:
            kw[f.name] = name
        elif hint is bytes:
            kw[f.name] = name.encode()
        elif hint == (bytes | None):
            kw[f.name] = b"\x08\x05"
        elif dataclasses.is_dataclass(hint) and hint.__name__ == "Timestamp":
            kw[f.name] = hint(T0 + i, 17)
        elif dataclasses.is_dataclass(hint):
            kw[f.name] = _sample(at, getattr(at, hint.__name__), depth + 1)
        elif f.name == "txs":
            kw[f.name] = [b"tx-a", b"tx-b"]
        elif f.name == "votes":
            item = "ExtendedVoteInfo" if "Extended" in cls.__name__ \
                else "VoteInfo"
            kw[f.name] = [_sample(at, getattr(at, item), depth + 1)] * 2
        elif f.name in _LIST_ITEMS:
            kw[f.name] = [_sample(at, getattr(at, _LIST_ITEMS[f.name]),
                                  depth + 1)] * 2
        elif f.name == "refetch_chunks":
            kw[f.name] = [1, 4]
        elif f.name == "reject_senders":
            kw[f.name] = ["peer-a", "peer-b"]
        else:
            raise AssertionError(f"no sample for {name}: {hint}")
    return cls(**kw)


_ABCI = sorted(n for n, c in vars(PORT.at).items()
               if isinstance(c, type) and dataclasses.is_dataclass(c)
               and hasattr(c, "to_proto"))


@pytest.mark.parametrize("name", _ABCI)
def test_abci_message_codec_equal_jax(name):
    t = _sample(PORT.at, getattr(PORT.at, name))
    j = _sample(JAX.at, getattr(JAX.at, name))
    wire = j.to_proto()
    assert t.to_proto() == wire
    assert getattr(PORT.at, name).from_proto(wire) == t
    assert getattr(PORT.at, name)().to_proto() == \
        getattr(JAX.at, name)().to_proto()


def test_tx_results_hash_and_kvstore_finalize_equal_jax():
    spec = chain_spec()
    txs = spec["txs"][2] + [b"bad", b"val:!!", b"k=v", b"val:" +
                            base64.b64encode(bytes(32)) + b"!3"]
    outs = []
    for ns in (JAX, PORT):
        app = ns.kv.KVStoreApplication(snapshot_interval=1)
        resp = app.finalize_block(ns.at.FinalizeBlockRequest(
            txs=txs, height=1))
        app.commit(ns.at.CommitRequest())
        snaps = app.list_snapshots(ns.at.ListSnapshotsRequest())
        chunk = app.load_snapshot_chunk(ns.at.LoadSnapshotChunkRequest(
            height=1, format=1, chunk=0))
        outs.append((resp.to_proto(),
                     ns.state.tx_results_hash(resp.tx_results),
                     snaps.to_proto(), chunk.to_proto(),
                     app.info(ns.at.InfoRequest()).to_proto(),
                     app.query(ns.at.QueryRequest(data=b"k")).to_proto(),
                     app.check_tx(ns.at.CheckTxRequest(tx=b"x")).to_proto()))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("backend", ["mem", "sqlite"])
def test_kv_stores_equal_jax(backend, tmp_path):
    dbs = [ns.kvdb.open_db(backend, str(tmp_path / f"{i}.db"))
           for i, ns in enumerate((JAX, PORT))]
    rng = np.random.default_rng(5)
    for step in range(200):
        k = PORT.kvdb.be64(int(rng.integers(0, 40)))
        op = int(rng.integers(0, 4))
        for db in dbs:
            if op == 0:
                db.set(k, b"v%d" % step)
            elif op == 1:
                db.delete(k)
            elif op == 2:
                db.write_batch([(k, b"b%d" % step),
                                (k + b"x", b"c")], [PORT.kvdb.be64(3)])
        lo, hi = sorted(PORT.kvdb.be64(int(x))
                        for x in rng.integers(0, 40, 2))
        for rev in (False, True):
            assert list(dbs[1].iterate(lo, hi, rev)) == \
                list(dbs[0].iterate(lo, hi, rev))
        assert dbs[1].get(k) == dbs[0].get(k)
    assert list(dbs[1].iterate()) == list(dbs[0].iterate())
    for db in dbs:
        db.close()
