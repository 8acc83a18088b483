"""The port's FilePV (privval/file.py) against the JAX package's, on the
CPU.

Both packages' FilePV hold the same ed25519 key (from a numpy seed) and
get the same sequence of sign requests: votes and proposals at rising
heights, rounds and steps, repeats of the last request, repeats that
differ only in their timestamp (re-signed with the saved signature and
timestamp), conflicting repeats and regressions (DoubleSignError),
precommits with vote extensions.  The signatures, the errors, the
timestamps handed back and the key and LastSignState files must be
identical after every request, and each package must load the other's
files and go on the same way.  canonical.split_timestamp is compared on
the same sign-bytes."""

import gc
import types

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.privval import file as jfile
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import canonical as jcan
from cometbft_tpu.types import timestamp as jts
from cometbft_tpu.types import vote as jvote
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.privval import file as tfile
from cometbft_tpu_torch.types import block as tblock
from cometbft_tpu_torch.types import canonical as tcan
from cometbft_tpu_torch.types import timestamp as tts
from cometbft_tpu_torch.types import vote as tvote

JAX = types.SimpleNamespace(ed=jed, pv=jfile, block=jblock, can=jcan,
                            ts=jts, vote=jvote)
PORT = types.SimpleNamespace(ed=ted, pv=tfile, block=tblock, can=tcan,
                             ts=tts, vote=tvote)
CHAIN = "privval-chain"
SEED = 20261022


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


def _requests(seed):
    """(kind, height, round, type, block tag, timestamp, extension) for a
    walk of sign requests: fresh ones, exact repeats, timestamp-only
    repeats, conflicting repeats and regressions."""
    rng = np.random.default_rng(seed)
    out, h, r = [], 1, 0
    for _ in range(28):
        roll = rng.random()
        if roll < 0.35 and out:
            k, *rest = out[-1]
            if rng.random() < 0.5:
                rest[4] = (int(rng.integers(100, 999)), int(rng.integers(0, 10**9)))
            else:
                rest[3] = int(rng.integers(0, 3))        # another block
            out.append((k, *rest))
            continue
        if roll < 0.45 and h > 2:
            out.append(("vote", h - 1, 0, 1, 0, (50, 0), b""))   # regression
            continue
        if rng.random() < 0.3:
            h += 1
            r = 0
        elif rng.random() < 0.2:
            r += 1
        kind = ("proposal", "vote", "vote")[int(rng.integers(0, 3))]
        vtype = int(rng.integers(1, 3))
        ext = b"ext%d" % h if vtype == 2 and rng.random() < 0.5 else b""
        out.append((kind, h, r, vtype, int(rng.integers(0, 3)),
                    (int(rng.integers(100, 999)), 0), ext))
    return out


def _block_id(ns, tag):
    if tag == 2:
        return ns.block.BlockID()
    return ns.block.BlockID(bytes([tag + 1]) * 32,
                            ns.block.PartSetHeader(1, bytes([tag + 9]) * 32))


def _sign(ns, pv, req):
    kind, h, r, vtype, tag, ts, ext = req
    try:
        if kind == "proposal":
            p = ns.vote.Proposal(height=h, round=r, pol_round=-1,
                                 block_id=_block_id(ns, tag),
                                 timestamp=ns.ts.Timestamp(*ts))
            pv.sign_proposal(CHAIN, p)
            return ("ok", p.signature, (p.timestamp.seconds,
                                        p.timestamp.nanos))
        v = ns.vote.Vote(type=vtype, height=h, round=r,
                         block_id=_block_id(ns, tag),
                         timestamp=ns.ts.Timestamp(*ts),
                         validator_address=pv.get_address(),
                         validator_index=0, extension=ext)
        pv.sign_vote(CHAIN, v, sign_extension=bool(ext) or vtype == 2)
        return ("ok", v.signature, v.extension_signature,
                (v.timestamp.seconds, v.timestamp.nanos))
    except Exception as e:               # noqa: BLE001
        return (type(e).__name__, str(e))


def _walk(ns, d, reqs, pv=None):
    key, state = str(d / "key.json"), str(d / "state.json")
    if pv is None:
        priv = ns.ed.PrivKey.generate(bytes(range(32)))
        pv = ns.pv.FilePV(priv, key, state)
        pv.save()
    out = []
    for req in reqs:
        out.append((_sign(ns, pv, req), (d / "state.json").read_bytes()))
    return out, (d / "key.json").read_bytes()


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_same_signatures_refusals_and_files(tmp_path, seed):
    reqs = _requests(seed)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    j = _walk(JAX, tmp_path / "j", reqs)
    t = _walk(PORT, tmp_path / "t", reqs)
    assert t == j
    kinds = {r[0][0] for r in t[0]}
    assert "ok" in kinds and "DoubleSignError" in kinds
    # a timestamp-only repeat handed back the saved signature and time
    oks = [r[0] for r in t[0] if r[0][0] == "ok"]
    assert len({o[1] for o in oks}) < len(oks)


def test_each_loads_the_others_files(tmp_path):
    reqs = _requests(SEED)
    first, then = reqs[:14], reqs[14:]
    out = []
    for writer, reader in ((JAX, PORT), (PORT, JAX)):
        d = tmp_path / f"{writer is JAX}"
        d.mkdir()
        _walk(writer, d, first)
        pv = reader.pv.FilePV.load(str(d / "key.json"), str(d / "state.json"))
        got, key = _walk(reader, d, then, pv=pv)
        out.append((got, key, pv.get_address(),
                    pv.get_pub_key().bytes()))
    assert out[0] == out[1]


def test_generate_load_or_generate_and_reset(tmp_path):
    got = []
    for ns, d in ((JAX, "j"), (PORT, "t")):
        p = tmp_path / d
        p.mkdir()
        pv = ns.pv.FilePV.generate(str(p / "k.json"), str(p / "s.json"),
                                   seed=b"\x07" * 32)
        pv.save()
        again = ns.pv.FilePV.load_or_generate(str(p / "k.json"),
                                              str(p / "s.json"))
        _sign(ns, again, ("vote", 3, 1, 1, 0, (100, 0), b""))
        s1 = (p / "s.json").read_bytes()
        again.reset()
        got.append(((p / "k.json").read_bytes(), s1,
                    (p / "s.json").read_bytes(),
                    again.sign_bytes_raw(b"raw payload")))
    assert got[0] == got[1]


def test_split_timestamp():
    bid = (jblock.BlockID(b"\x01" * 32, jblock.PartSetHeader(1, b"\x02" * 32)),
           tblock.BlockID(b"\x01" * 32, tblock.PartSetHeader(1, b"\x02" * 32)))
    for ts in ((0, 0), (1, 2), (1_700_000_000, 999_999_999)):
        jv = jvote.Vote(type=2, height=9, round=3, block_id=bid[0],
                        timestamp=jts.Timestamp(*ts))
        tv = tvote.Vote(type=2, height=9, round=3, block_id=bid[1],
                        timestamp=tts.Timestamp(*ts))
        jsb, tsb = jv.sign_bytes(CHAIN), tv.sign_bytes(CHAIN)
        assert jsb == tsb
        jz, jt = jcan.split_timestamp(jsb, jcan.VOTE_TIMESTAMP_FIELD)
        tz, tt = tcan.split_timestamp(tsb, tcan.VOTE_TIMESTAMP_FIELD)
        assert tz == jz and (tt.seconds, tt.nanos) == (jt.seconds, jt.nanos)
        jp = jvote.Proposal(height=9, round=3, pol_round=1, block_id=bid[0],
                            timestamp=jts.Timestamp(*ts))
        tp = tvote.Proposal(height=9, round=3, pol_round=1, block_id=bid[1],
                            timestamp=tts.Timestamp(*ts))
        assert tcan.split_timestamp(
            tp.sign_bytes(CHAIN), tcan.PROPOSAL_TIMESTAMP_FIELD)[0] == \
            jcan.split_timestamp(jp.sign_bytes(CHAIN),
                                 jcan.PROPOSAL_TIMESTAMP_FIELD)[0]
