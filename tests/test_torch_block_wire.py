"""The port's wire types against the JAX package on the CPU: seeded
numpy-random headers, data, blocks, commits, light blocks and both
evidence kinds built field for field in each package, with equal proto
bytes (both ways through from_proto), hash(), Commit.median_time,
evidence_hash, get_byzantine_validators and the evidence hashes; the
public-key codec for ed25519, secp256k1 and bls12_381; and the recorded
CometBFT /commit + /validators fixture decoded by the port's rpc_decode
to its frozen header hash, its commit verified on device="cpu"."""

import json
import os
import types

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import bls12381 as jbls
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import encoding as jenc
from cometbft_tpu.crypto import secp256k1 as jsecp
from cometbft_tpu.light import rpc_decode as jrpc
from cometbft_tpu.light import types as jlight
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import evidence as jev
from cometbft_tpu.types import timestamp as jts
from cometbft_tpu.types import validator_set as jvset
from cometbft_tpu.types import vote as jvote
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import bls12381 as tbls
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import encoding as tenc
from cometbft_tpu_torch.crypto import secp256k1 as tsecp
from cometbft_tpu_torch.crypto import sigcache
from cometbft_tpu_torch.light import rpc_decode as trpc
from cometbft_tpu_torch.light import types as tlight
from cometbft_tpu_torch.types import block as tblock
from cometbft_tpu_torch.types import evidence as tev
from cometbft_tpu_torch.types import timestamp as tts
from cometbft_tpu_torch.types import validation as tval
from cometbft_tpu_torch.types import validator_set as tvset
from cometbft_tpu_torch.types import vote as tvote

CPU = "cpu"
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "real_chain_commit.json")
# tests/test_real_chain_fixture.py's frozen literals
HEADER_HASH = \
    "43D14604A8621DBD99EC550B4E59B61F9DE9F86F3500F730764B79F6C750AEFB"
FIXTURE_CHAIN, FIXTURE_HEIGHT = "pin-chain-1", 12

JAX = types.SimpleNamespace(block=jblock, ev=jev, ts=jts, vset=jvset,
                            vote=jvote, light=jlight, ed=jed)
PORT = types.SimpleNamespace(block=tblock, ev=tev, ts=tts, vset=tvset,
                             vote=tvote, light=tlight, ed=ted)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cache():
    sigcache.reset()
    sigcache.set_enabled(None)
    yield
    sigcache.reset()


def maybe(rng, n):
    return rng.bytes(n) if rng.random() < 0.8 else b""


def header_fields(rng):
    return dict(
        version=(int(rng.integers(0, 2**40)), int(rng.integers(0, 2**20))),
        chain_id="c" * int(rng.integers(0, 50)),
        height=int(rng.integers(0, 2**62)),
        time=(int(rng.integers(0, 2**40)), int(rng.integers(0, 10**9))),
        last_block_id=(maybe(rng, 32), int(rng.integers(0, 9)),
                       maybe(rng, 32)),
        **{k: maybe(rng, 32) for k in (
            "last_commit_hash", "data_hash", "validators_hash",
            "next_validators_hash", "consensus_hash", "app_hash",
            "last_results_hash", "evidence_hash")},
        proposer_address=maybe(rng, 20))


def make_header(side, f):
    b = side.block
    kw = dict(f)
    kw["version"] = b.Consensus(*f["version"])
    kw["time"] = side.ts.Timestamp(*f["time"])
    h, total, ph = f["last_block_id"]
    kw["last_block_id"] = b.BlockID(h, b.PartSetHeader(total, ph))
    return b.Header(**kw)


def commit_fields(rng, addrs, height=None):
    sigs = []
    for a in addrs:
        flag = int(rng.choice([1, 2, 2, 2, 3]))
        if flag == 1:
            sigs.append((1, b"", (0, 0), b""))
        else:
            sigs.append((flag, a, (int(rng.integers(1, 2**33)),
                                   int(rng.integers(0, 10**9))),
                         rng.bytes(64)))
    return dict(height=height if height is not None
                else int(rng.integers(1, 2**40)),
                round=int(rng.integers(0, 5)),
                block_id=(rng.bytes(32), int(rng.integers(1, 9)),
                          rng.bytes(32)), sigs=sigs)


def make_commit(side, f):
    b = side.block
    h, total, ph = f["block_id"]
    return b.Commit(f["height"], f["round"],
                    b.BlockID(h, b.PartSetHeader(total, ph)),
                    [b.CommitSig(flag, a, side.ts.Timestamp(*ts), s)
                     for flag, a, ts, s in f["sigs"]])


def make_valset(side, raws, powers):
    return side.vset.ValidatorSet([
        side.vset.Validator(side.ed.PubKey(r), p)
        for r, p in zip(raws, powers)])


def make_light_block(side, hf, cf, raws, powers):
    return side.light.LightBlock(
        side.light.SignedHeader(make_header(side, hf), make_commit(side, cf)),
        make_valset(side, raws, powers))


def both(fn, *a):
    return fn(JAX, *a), fn(PORT, *a)


@pytest.mark.parametrize("seed", range(6))
def test_header_proto_and_hash(seed):
    rng = np.random.default_rng(seed)
    f = header_fields(rng)
    jh, th = both(make_header, f)
    assert th.to_proto() == jh.to_proto()
    assert th.hash() == jh.hash()
    assert tblock.Header.from_proto(jh.to_proto()).to_proto() == \
        jh.to_proto()
    assert jblock.Header.from_proto(th.to_proto()).hash() == jh.hash()
    for h in (jh, th):
        h.validators_hash = b""
    assert th.hash() is None and jh.hash() is None
    # validate_basic: same verdict, same message, on each broken field
    for name, bad in (("data_hash", b"\x01" * 31), ("chain_id", "x" * 51),
                      ("proposer_address", b"\x02" * 19),
                      ("evidence_hash", b"\x03" * 33), ("height", -1)):
        jh, th = both(make_header, {**f, name: bad})
        got = []
        for h in (jh, th):
            try:
                h.validate_basic()
                got.append(None)
            except ValueError as e:
                got.append(str(e))
        assert got[0] == got[1] and got[0] is not None, name


def test_consensus_and_tx_hash():
    for block, app in ((11, 0), (0, 1), (2**40, 2**33)):
        j, t = jblock.Consensus(block, app), tblock.Consensus(block, app)
        assert t.to_proto() == j.to_proto()
        assert tblock.Consensus.from_proto(j.to_proto()) == t
    rng = np.random.default_rng(20)
    for n in (0, 1, 77):
        tx = rng.bytes(n)
        assert tblock.tx_hash(tx) == jblock.tx_hash(tx)


@pytest.mark.parametrize("seed", range(4))
def test_data_commit_median_time(seed):
    rng = np.random.default_rng(100 + seed)
    txs = [rng.bytes(int(rng.integers(0, 300)))
           for _ in range(int(rng.integers(0, 12)))]
    jd, td = jblock.Data(list(txs)), tblock.Data(list(txs))
    assert td.hash() == jd.hash() and td.to_proto() == jd.to_proto()
    assert tblock.Data.from_proto(jd.to_proto()).txs == txs
    raws = [rng.bytes(32) for _ in range(9)]
    powers = [int(p) for p in rng.integers(1, 100, size=9)]
    jv, tv = both(make_valset, raws, powers)
    addrs = [v.address for v in jv.validators]
    cf = commit_fields(rng, addrs)
    jc, tc = both(make_commit, cf)
    assert tc.to_proto() == jc.to_proto() and tc.hash() == jc.hash()
    assert tblock.Commit.from_proto(jc.to_proto()).to_proto() == jc.to_proto()
    assert tc.median_time(tv) == tts.Timestamp(
        *(lambda t: (t.seconds, t.nanos))(jc.median_time(jv)))
    # a commit no validator of the set signed
    empty = both(make_commit, commit_fields(rng, [rng.bytes(20)] * 3))
    assert empty[1].median_time(tv).is_zero() and \
        empty[0].median_time(jv).is_zero()


def _votes(side, rng_vals, addr):
    """Two conflicting prevotes of one validator (fixed fields)."""
    b = side.block
    out = []
    for k in (1, 2):
        out.append(side.vote.Vote(
            type=1, height=rng_vals["h"], round=0,
            block_id=b.BlockID(bytes([k]) * 32, b.PartSetHeader(1, b"\x09" * 32)),
            timestamp=side.ts.Timestamp(rng_vals["t"], k),
            validator_address=addr, validator_index=0,
            signature=rng_vals["sig" + str(k)]))
    return out


def _evidence(side, rng_vals, hf, cf, raws, powers):
    vs = make_valset(side, raws, powers)
    va, vb = _votes(side, rng_vals, vs.validators[0].address)
    dup = side.ev.DuplicateVoteEvidence.new(
        va, vb, side.ts.Timestamp(rng_vals["t"], 0), vs)
    lb = make_light_block(side, hf, cf, raws, powers)
    lca = side.ev.LightClientAttackEvidence(
        conflicting_block=lb, common_height=rng_vals["common"],
        byzantine_validators=[v.copy() for v in vs.validators[:3]],
        total_voting_power=vs.total_voting_power(),
        timestamp=side.ts.Timestamp(rng_vals["t"], 5))
    return dup, lca


@pytest.mark.parametrize("seed", range(3))
def test_evidence_and_block(seed):
    rng = np.random.default_rng(200 + seed)
    raws = [rng.bytes(32) for _ in range(5)]
    powers = [int(p) for p in rng.integers(1, 50, size=5)]
    jvs = make_valset(JAX, raws, powers)
    addrs = [v.address for v in jvs.validators]
    hf = {**header_fields(rng), "validators_hash": rng.bytes(32)}
    cf = commit_fields(rng, addrs)
    rv = {"h": int(rng.integers(1, 2**30)), "t": int(rng.integers(1, 2**32)),
          "common": int(rng.integers(-5, 2**40)),
          "sig1": rng.bytes(64), "sig2": rng.bytes(64)}
    jevs = _evidence(JAX, rv, hf, cf, raws, powers)
    tevs = _evidence(PORT, rv, hf, cf, raws, powers)
    for je, te in zip(jevs, tevs):
        assert te.to_proto() == je.to_proto()
        assert te.hash() == je.hash()
        wrapped = jev.evidence_to_proto_wrapped(je)
        assert tev.evidence_to_proto_wrapped(te) == wrapped
        back = tev.evidence_from_proto_wrapped(wrapped)
        assert type(back).__name__ == type(je).__name__
        assert back.to_proto() == je.to_proto()
    assert tblock.evidence_hash(list(tevs)) == jblock.evidence_hash(
        list(jevs))
    assert tblock.evidence_list_proto(list(tevs)) == \
        jblock.evidence_list_proto(list(jevs))
    # a block carrying both, its header filled, then checked
    txs = [rng.bytes(40) for _ in range(3)]
    hf2 = {**header_fields(rng), "validators_hash": rng.bytes(32),
           "last_commit_hash": b"", "data_hash": b"", "evidence_hash": b""}
    blocks = []
    for side, evs in ((JAX, jevs), (PORT, tevs)):
        blk = side.block.Block(make_header(side, hf2),
                               side.block.Data(list(txs)), list(evs),
                               make_commit(side, cf))
        blk.fill_header()
        blk.validate_basic()
        blocks.append(blk)
    jb, tb = blocks
    assert tb.to_proto() == jb.to_proto() and tb.hash() == jb.hash()
    tb2 = tblock.Block.from_proto(jb.to_proto())
    assert tb2.to_proto() == jb.to_proto()
    assert [type(e).__name__ for e in tb2.evidence] == \
        ["DuplicateVoteEvidence", "LightClientAttackEvidence"]
    tb2.data = tblock.Data(txs[:2])
    with pytest.raises(ValueError, match="wrong DataHash"):
        tb2.validate_basic()


def test_byzantine_validators():
    """Lunatic, equivocation and amnesia, as the JAX package judges."""
    rng = np.random.default_rng(300)
    raws = [rng.bytes(32) for _ in range(6)]
    powers = [10] * 6
    addrs = [v.address for v in make_valset(JAX, raws, powers).validators]
    hf = {**header_fields(rng), "validators_hash": rng.bytes(32)}
    cf_a = commit_fields(rng, addrs, height=7)
    cf_b = {**commit_fields(rng, addrs, height=7), "round": cf_a["round"]}
    cases = [
        ("lunatic", {**hf, "app_hash": rng.bytes(32)}, cf_b),
        ("equivocation", hf, cf_b),
        ("amnesia", hf, {**cf_b, "round": cf_a["round"] + 1}),
    ]
    for label, hf_conf, cf_conf in cases:
        got = []
        for side in (JAX, PORT):
            common = make_valset(side, raws, powers)
            trusted = make_light_block(side, hf, cf_a, raws, powers)
            conflicting = make_light_block(side, hf_conf, cf_conf, raws,
                                           powers)
            byz = side.ev.get_byzantine_validators(
                common, trusted.signed_header, conflicting)
            got.append([v.to_proto() for v in byz])
        assert got[1] == got[0], label
        assert (len(got[0]) > 0) == (label != "amnesia"), label


def test_light_block_proto_both_ways():
    rng = np.random.default_rng(400)
    raws = [rng.bytes(32) for _ in range(4)]
    powers = [3, 4, 5, 6]
    addrs = [v.address for v in make_valset(JAX, raws, powers).validators]
    hf, cf = header_fields(rng), commit_fields(rng, addrs)
    jlb = make_light_block(JAX, hf, cf, raws, powers)
    tlb = convert.light_block_from_proto(jlb)
    assert tlb.to_proto() == jlb.to_proto()
    assert jlight.LightBlock.from_proto(tlb.to_proto()).to_proto() == \
        jlb.to_proto()
    assert tlb.signed_header.to_proto() == jlb.signed_header.to_proto()
    assert tlb.hash() == jlb.hash()
    assert convert.light_block_from_proto(jlb.to_proto()).to_proto() == \
        jlb.to_proto()


# -- keys ----------------------------------------------------------------------

def test_pubkey_codec_three_types():
    rng = np.random.default_rng(500)
    cases = [("ed25519", rng.bytes(32)),
             ("secp256k1", b"\x02" + rng.bytes(32)),
             ("bls12_381", rng.bytes(48))]
    for key_type, raw in cases:
        jk = jenc.make_pubkey(key_type, raw)
        tk = tenc.make_pubkey(key_type, raw)
        assert (tk.type(), tk.bytes(), tk.address()) == \
            (jk.type(), jk.bytes(), jk.address())
        wire = jenc.pubkey_to_proto(jk)
        assert tenc.pubkey_to_proto(tk) == wire
        back = tenc.pubkey_from_proto(wire)
        assert (back.type(), back.bytes(), back.address()) == \
            (jk.type(), jk.bytes(), jk.address())
    assert isinstance(tenc.make_pubkey("ed25519", b"\x01" * 32), ted.PubKey)
    assert isinstance(tenc.make_pubkey("secp256k1", b"\x02" * 33),
                      tsecp.PubKey)
    assert isinstance(tenc.make_pubkey("bls12_381", b"\x03" * 48),
                      tbls.PubKey)
    # a message with no known field, an unknown type, a wrong size
    from cometbft_tpu_torch.libs import protowire as tpw
    for payload in (b"", tpw.Writer().bytes_field(9, b"\x01" * 32).bytes()):
        with pytest.raises(ValueError) as te:
            tenc.pubkey_from_proto(payload)
        with pytest.raises(ValueError) as je:
            jenc.pubkey_from_proto(payload)
        assert str(te.value) == str(je.value)
    for key_type, raw in (("sr25519", b"\x01" * 32), ("ed25519", b"\x01")):
        with pytest.raises(ValueError) as te:
            tenc.make_pubkey(key_type, raw)
        with pytest.raises(ValueError) as je:
            jenc.make_pubkey(key_type, raw)
        assert str(te.value) == str(je.value)
    # a validator set of all three types hashes alike
    raws = [raw for _, raw in cases]
    jv = jvset.ValidatorSet([jvset.Validator(jenc.make_pubkey(k, r), 7)
                             for (k, _), r in zip(cases, raws)])
    tv = convert.validator_set_from_proto(jv)
    assert tv.hash(device=CPU) == jv.hash()
    assert [v.pub_key.type() for v in tv.validators] == \
        [v.pub_key.type() for v in jv.validators]
    assert jbls.KEY_TYPE == tbls.KEY_TYPE


# -- the recorded chain --------------------------------------------------------

@pytest.fixture(scope="module")
def fx():
    with open(FIXTURE) as f:
        return json.load(f)


def test_fixture_header_hash_and_commit(fx):
    sh_json = fx["commit_response"]["result"]["signed_header"]
    vals_json = fx["validators_response"]["result"]["validators"]
    sh = trpc.signed_header_from_rpc(sh_json)
    assert sh.header.chain_id == FIXTURE_CHAIN
    assert sh.header.height == FIXTURE_HEIGHT
    assert sh.header.hash().hex().upper() == HEADER_HASH
    assert sh.header.hash().hex().upper() == sh_json["commit"]["block_id"][
        "hash"]
    jsh = jrpc.signed_header_from_rpc(sh_json)
    assert sh.to_proto() == jsh.to_proto()
    vals = tvset.ValidatorSet(trpc.validators_from_rpc(vals_json))
    jvals = jvset.ValidatorSet(jrpc.validators_from_rpc(vals_json))
    assert vals.to_proto() == jvals.to_proto()
    assert vals.hash(device=CPU) == sh.header.validators_hash
    for v, item in zip(vals.validators, vals_json):
        assert v.pub_key.address().hex().upper() == item["address"]
    tval.verify_commit_light(FIXTURE_CHAIN, vals, sh.commit.block_id,
                             FIXTURE_HEIGHT, sh.commit, device=CPU)
    vals.verify_commit_light(FIXTURE_CHAIN, sh.commit.block_id,
                             FIXTURE_HEIGHT, sh.commit, device=CPU)
    lb = tlight.LightBlock(sh, vals)
    lb.validate_basic(FIXTURE_CHAIN, device=CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lb.validate_basic(FIXTURE_CHAIN)
