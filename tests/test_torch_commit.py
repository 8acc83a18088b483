"""The port's slice as a whole: commit verification through
verify_commit_light, verify_commit, verify_commit_light_trusting and
DeferredSigBatch, on the same small commits in both packages.  Every
outcome — pass, or the error class and its message — must be identical.
The port runs with device="cpu" and lowered device thresholds, so its
RLC program and its per-signature localization both run (plain
versions); the JAX package verifies on its host path.  Both packages run
with their signature caches off (tests/test_torch_sigcache.py holds the
port's cache)."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import sigcache
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import canonical as jcanon
from cometbft_tpu.types import validation as jval
from cometbft_tpu.types.timestamp import Timestamp as JTimestamp
from cometbft_tpu.types.validator_set import (Validator as JValidator,
                                              ValidatorSet as JValidatorSet)
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import sigcache as tsigcache
from cometbft_tpu_torch.ops import ed25519 as tdev
from cometbft_tpu_torch.types import block as tblock
from cometbft_tpu_torch.types import validation as tval
from cometbft_tpu_torch.types.timestamp import Timestamp as TTimestamp
from cometbft_tpu_torch.types.validator_set import (
    Validator as TValidator, ValidatorSet as TValidatorSet)

CHAIN_ID = "torch-port-chain"
N_VALS = 7
HEIGHT = 12


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


@pytest.fixture(autouse=True)
def _paths(monkeypatch, _port_sigcache):
    """Both packages: no verdict cache (each entry point of a case runs
    its own programs).  Port side: device thresholds low enough that a
    <=7-signature commit takes the RLC program; count the RLC and
    localization dispatches."""
    monkeypatch.setattr(sigcache, "_enabled_override", False)
    monkeypatch.setattr(tsigcache, "_enabled_override", False)
    monkeypatch.setattr(tbatch, "DEVICE_THRESHOLD", 2)
    monkeypatch.setattr(tval.DeferredSigBatch, "DEVICE_THRESHOLD", 2)
    calls = {"rlc": 0, "persig": 0}
    rlc, persig = ted.rlc_verify, tdev.verify_kernel

    def rlc_spy(*a, **k):
        calls["rlc"] += 1
        return rlc(*a, **k)

    def persig_spy(*a, **k):
        calls["persig"] += 1
        return persig(*a, **k)

    monkeypatch.setattr(ted, "rlc_verify", rlc_spy)
    monkeypatch.setattr(tdev, "verify_kernel", persig_spy)
    return calls


_PRIVS = [jed.PrivKey.generate(bytes([40 + i]) * 32) for i in range(N_VALS)]


def _valsets():
    jvals = JValidatorSet([JValidator(p.pub_key(), 10) for p in _PRIVS])
    tvals = TValidatorSet([TValidator(ted.PubKey(p.pub_key().bytes()), 10)
                           for p in _PRIVS])
    assert [v.address for v in jvals.validators] == \
        [v.address for v in tvals.validators]
    return jvals, tvals


def _commits(flags, tamper=None, height=HEIGHT, n_sigs=N_VALS):
    """The same commit in both packages.  flags[i] is validator i's
    BlockIDFlag (COMMIT, NIL or ABSENT); tamper flips a byte of that
    signature."""
    jvals, _ = _valsets()
    by_addr = {p.pub_key().address(): p for p in _PRIVS}
    bid = jblock.BlockID(b"\x0b" * 32, jblock.PartSetHeader(1, b"\x0c" * 32))
    jsigs, tsigs = [], []
    for i, v in enumerate(jvals.validators[:n_sigs]):
        flag = flags[i]
        if flag == jblock.BLOCK_ID_FLAG_ABSENT:
            jsigs.append(jblock.CommitSig())
            tsigs.append(tblock.CommitSig())
            continue
        ts = JTimestamp(1_700_000_000 + i, 1000 * i)
        signed = bid if flag == jblock.BLOCK_ID_FLAG_COMMIT else \
            jblock.BlockID()
        sb = jcanon.vote_sign_bytes(CHAIN_ID, 2, height, 0, signed, ts)
        sig = by_addr[v.address].sign(sb)
        if i == tamper:
            sig = sig[:9] + bytes([sig[9] ^ 0x20]) + sig[10:]
        jsigs.append(jblock.CommitSig(flag, v.address, ts, sig))
        tsigs.append(tblock.CommitSig(flag, v.address,
                                      TTimestamp(ts.seconds, ts.nanos), sig))
    tbid = tblock.BlockID(bid.hash, tblock.PartSetHeader(
        bid.part_set_header.total, bid.part_set_header.hash))
    return (jblock.Commit(height, 0, bid, jsigs),
            tblock.Commit(height, 0, tbid, tsigs), bid, tbid)


C, NIL, ABS = (jblock.BLOCK_ID_FLAG_COMMIT, jblock.BLOCK_ID_FLAG_NIL,
               jblock.BLOCK_ID_FLAG_ABSENT)
CASES = {
    "valid": dict(flags=[C] * N_VALS),
    "valid_nil_absent": dict(flags=[C, NIL, C, C, ABS, C, C]),
    "tampered": dict(flags=[C] * N_VALS, tamper=2),
    "tampered_nil": dict(flags=[C, C, C, C, NIL, C, C], tamper=4),
    "under_two_thirds": dict(flags=[C, ABS, C, ABS, C, NIL, C]),
    "wrong_height": dict(flags=[C] * N_VALS, height=HEIGHT + 1),
    "wrong_set_size": dict(flags=[C] * N_VALS, n_sigs=N_VALS - 1),
}


def _outcome(fn):
    try:
        fn()
    except Exception as e:                      # noqa: BLE001
        return type(e).__name__, str(e), getattr(e, "failed_ctx", None)
    return None


def _entry_points(jvals, tvals, jc, tc, jbid, tbid):
    def deferred(validation, vals, commit, bid, **kw):
        def run():
            batch = validation.DeferredSigBatch()
            validation.verify_commit_light(CHAIN_ID, vals, bid, HEIGHT,
                                           commit, defer_to=batch, **kw)
            batch.verify(**kw)
        return run

    tl_j = jval.Fraction(1, 3)
    tl_t = tval.Fraction(1, 3)
    return {
        "verify_commit_light": (
            lambda: jval.verify_commit_light(CHAIN_ID, jvals, jbid, HEIGHT,
                                             jc),
            lambda: tval.verify_commit_light(CHAIN_ID, tvals, tbid, HEIGHT,
                                             tc, device="cpu")),
        "verify_commit": (
            lambda: jval.verify_commit(CHAIN_ID, jvals, jbid, HEIGHT, jc),
            lambda: tval.verify_commit(CHAIN_ID, tvals, tbid, HEIGHT, tc,
                                       device="cpu")),
        "verify_commit_light_trusting": (
            lambda: jval.verify_commit_light_trusting(CHAIN_ID, jvals, jc,
                                                      tl_j),
            lambda: tval.verify_commit_light_trusting(CHAIN_ID, tvals, tc,
                                                      tl_t, device="cpu")),
        "deferred": (deferred(jval, jvals, jc, jbid),
                     deferred(tval, tvals, tc, tbid, device="cpu")),
    }


@pytest.mark.parametrize("case", sorted(CASES))
def test_commit_outcomes_match(case, _paths):
    jc, tc, jbid, tbid = _commits(**CASES[case])
    jvals, tvals = _valsets()
    outcomes = {}
    for name, (jfn, tfn) in _entry_points(jvals, tvals, jc, tc, jbid,
                                          tbid).items():
        want, got = _outcome(jfn), _outcome(tfn)
        assert got == want, (case, name)
        outcomes[name] = want
    if case.startswith("valid"):
        assert set(outcomes.values()) == {None} and _paths["rlc"] >= 4
    if case.startswith("tampered"):
        # verify_commit checks nil votes too; the light variants skip them
        assert outcomes["verify_commit"][0] == "ErrInvalidSignature"
        assert _paths["rlc"] >= 1 and _paths["persig"] >= 1


def test_tampered_messages_name_the_index(_paths):
    _, tc, _, tbid = _commits(**CASES["tampered"])
    _, tvals = _valsets()
    with pytest.raises(tval.ErrInvalidSignature,
                       match=r"^wrong signature \(#2\): "):
        tval.verify_commit(CHAIN_ID, tvals, tbid, HEIGHT, tc, device="cpu")
    batch = tval.DeferredSigBatch()
    tval.verify_commit_light(CHAIN_ID, tvals, tbid, HEIGHT, tc,
                             defer_to=batch, device="cpu")
    with pytest.raises(tval.ErrInvalidSignature) as ei:
        batch.verify(device="cpu")
    assert ei.value.failed_ctx == HEIGHT
    assert str(ei.value).startswith(f"wrong signature in commit at height "
                                    f"{HEIGHT}: ")


def test_entry_points_raise_without_card(monkeypatch):
    """No card and no explicit device="cpu": every entry point raises
    instead of carrying on on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc, _, tbid = _commits(**CASES["valid"])
    _, tvals = _valsets()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatch.create_batch_verifier("ed25519")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tval.verify_commit_light(CHAIN_ID, tvals, tbid, HEIGHT, tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tval.verify_commit(CHAIN_ID, tvals, tbid, HEIGHT, tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tval.DeferredSigBatch().verify()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ted.rlc_verify(ted.pack_rlc([b"\x00" * 32] * 2, [b""] * 2,
                                    [b"\x00" * 64] * 2))


def test_batch_verifier_routes_by_threshold():
    bv = tbatch.create_batch_verifier("ed25519", n_hint=1, device="cpu")
    assert isinstance(bv, tbatch.CpuEd25519BatchVerifier)
    bv = tbatch.create_batch_verifier("ed25519", n_hint=5, device="cpu")
    assert isinstance(bv, tbatch.CudaEd25519BatchVerifier)
    bv = tbatch.create_batch_verifier("secp256k1", n_hint=95, device="cpu")
    assert isinstance(bv, tbatch.CpuSecp256k1BatchVerifier)
    bv = tbatch.create_batch_verifier("secp256k1", n_hint=96, device="cpu")
    assert isinstance(bv, tbatch.CudaSecp256k1BatchVerifier)
    with pytest.raises(ValueError):
        tbatch.create_batch_verifier("bls12_381", device="cpu")


def test_sign_bytes_match():
    jc, tc, _, _ = _commits(**CASES["valid_nil_absent"])
    assert tc.vote_sign_bytes_all(CHAIN_ID) == \
        jc.vote_sign_bytes_all(CHAIN_ID)


_STANDALONE = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    sys.modules["cometbft_tpu"] = None
    sys.path.insert(0, sys.argv[1])
    import torch
    torch.set_num_threads(1)   # tiny tensors; no OpenMP spin beside busy workers
    from cometbft_tpu_torch.crypto import batch, ed25519 as ed
    from cometbft_tpu_torch.types import block, validation
    from cometbft_tpu_torch.types.canonical import vote_sign_bytes
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.validator_set import (Validator,
                                                        ValidatorSet)
    batch.DEVICE_THRESHOLD = 2
    privs = [ed.PrivKey.generate(bytes([i + 1]) * 32) for i in range(4)]
    vals = ValidatorSet([Validator(p.pub_key(), 5) for p in privs])
    by_addr = {p.pub_key().address(): p for p in privs}
    bid = block.BlockID(b"\\x01" * 32, block.PartSetHeader(1, b"\\x02" * 32))
    sigs = []
    for v in vals.validators:
        ts = Timestamp(1_700_000_000, 0)
        sb = vote_sign_bytes("c", 2, 3, 0, bid, ts)
        sigs.append(block.CommitSig(block.BLOCK_ID_FLAG_COMMIT, v.address,
                                    ts, by_addr[v.address].sign(sb)))
    validation.verify_commit("c", vals, bid, 3, block.Commit(3, 0, bid, sigs),
                             device="cpu")
    import importlib, pkgutil, cometbft_tpu_torch
    for m in pkgutil.walk_packages(cometbft_tpu_torch.__path__,
                                   "cometbft_tpu_torch."):
        importlib.import_module(m.name)
    from cometbft_tpu_torch.ops import cuda_msm, ed25519 as dev
    msgs = [b"m%d" % i for i in range(4)]
    packed = ed.pack_rlc([p.pub_key().bytes() for p in privs], msgs,
                         [p.sign(m) for p, m in zip(privs, msgs)])
    for major, loop, tree, fold, group in ((0, 1, 0, 1, 1), (1, 1, 0, 1, 4),
                                           (0, 0, 1, 1, 1), (1, 1, 0, 0, 1),
                                           (0, 0, 0, 1, 1)):
        dev.USE_PALLAS_MSM_MAJOR, dev.USE_PALLAS_MSM_LOOP = major, loop
        dev.USE_PALLAS_TREE, dev.USE_PALLAS_FOLD = tree, fold
        cuda_msm.WIN_GROUP = group
        assert ed.rlc_verify(packed, device="cpu")
    loaded = [m for m, mod in sys.modules.items() if mod is not None
              and (m in ("jax", "cometbft_tpu")
                   or m.startswith(("jax.", "cometbft_tpu.")))]
    assert not loaded, loaded
    print("OK")
""")


def test_port_runs_without_jax_or_jax_package(tmp_path):
    repo = str(Path(__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", _STANDALONE, repo],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"
