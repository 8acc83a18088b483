"""Mixed-key commits in the port against the JAX package: a validator set
of ed25519 and secp256k1 keys through verify_commit_light, verify_commit
and DeferredSigBatch, and MixedBatchVerifier on its own.  Every outcome
— pass, or the error class and its message, and a deferred window's
failed_ctx — must be identical.

The port runs with device="cpu" and its device thresholds lowered, so
each key type's device program runs (ed25519 RLC and localization,
secp256k1 MSM: their plain versions); the JAX package verifies on its
host loops with the signature cache off."""

import pytest
import torch

from cometbft_tpu.crypto import batch as jb
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import secp256k1 as jsk
from cometbft_tpu.crypto import sigcache
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import canonical as jcanon
from cometbft_tpu.types import validation as jval
from cometbft_tpu.types.timestamp import Timestamp as JTimestamp
from cometbft_tpu.types.validator_set import (Validator as JValidator,
                                              ValidatorSet as JValidatorSet)
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import secp256k1 as tsk
from cometbft_tpu_torch.types import block as tblock
from cometbft_tpu_torch.types import validation as tval
from cometbft_tpu_torch.types.timestamp import Timestamp as TTimestamp
from cometbft_tpu_torch.types.validator_set import (
    Validator as TValidator, ValidatorSet as TValidatorSet)

torch.set_num_threads(1)

CHAIN_ID = "torch-mixed-chain"
HEIGHT = 21

def _keys(make, n, pick):
    """n of 12 keys, picked by address: the secp256k1 ones sort below
    every ed25519 one, so each light commit's +2/3 prefix holds all three
    and every secp256k1 batch in this file has one key set (one K11
    build)."""
    pool = sorted((make(i) for i in range(12)),
                  key=lambda p: p.pub_key().address())
    return pool[:n] if pick == "low" else pool[-n:]


_PRIVS = (_keys(lambda i: jed.PrivKey.generate(bytes([90 + i]) * 32), 4,
                "high")
          + _keys(lambda i: jsk.PrivKey.generate(bytes([110 + i]) * 32), 3,
                  "low"))
assert max(p.pub_key().address() for p in _PRIVS[4:]) < \
    min(p.pub_key().address() for p in _PRIVS[:4])


def _port_key(pub):
    mod = ted if pub.type() == "ed25519" else tsk
    return mod.PubKey(pub.bytes())


@pytest.fixture(autouse=True)
def _paths(monkeypatch):
    """JAX side: host loops, no verdict cache.  Port side: device
    thresholds low enough that each key type's program runs; record the
    programs each port verify ran."""
    monkeypatch.setattr(sigcache, "_enabled_override", False)
    monkeypatch.setattr(jb, "DEVICE_THRESHOLD", 10 ** 9)
    monkeypatch.setattr(jb, "SECP_DEVICE_THRESHOLD", 10 ** 9)
    monkeypatch.setattr(tbatch, "DEVICE_THRESHOLD", 2)
    monkeypatch.setattr(tbatch, "SECP_DEVICE_THRESHOLD", 2)
    monkeypatch.setattr(tval.DeferredSigBatch, "DEVICE_THRESHOLD", 2)
    monkeypatch.delenv("COMETBFT_TPU_PROVIDER", raising=False)
    ran = []
    for cls in (tbatch.CudaEd25519BatchVerifier,
                tbatch.CudaSecp256k1BatchVerifier):
        real = cls.verify

        def spy(self, real=real, name=cls.__name__):
            ran.append(name)
            return real(self)
        monkeypatch.setattr(cls, "verify", spy)
    return ran


def _valsets(privs=_PRIVS):
    jvals = JValidatorSet([JValidator(p.pub_key(), 10) for p in privs])
    tvals = TValidatorSet([TValidator(_port_key(p.pub_key()), 10)
                           for p in privs])
    assert [v.address for v in jvals.validators] == \
        [v.address for v in tvals.validators]
    return jvals, tvals


def _commits(tamper=(), height=HEIGHT, privs=_PRIVS):
    """The same all-COMMIT commit in both packages; tamper names the key
    types whose first signer's signature gets a flipped byte."""
    jvals, _ = _valsets(privs)
    by_addr = {p.pub_key().address(): p for p in privs}
    bid = jblock.BlockID(b"\x21" * 32, jblock.PartSetHeader(1, b"\x22" * 32))
    jsigs, tsigs, seen = [], [], set()
    for i, v in enumerate(jvals.validators):
        ts = JTimestamp(1_700_000_000 + i, 1000 * i)
        sb = jcanon.vote_sign_bytes(CHAIN_ID, 2, height, 0, bid, ts)
        sig = by_addr[v.address].sign(sb)
        kt = v.pub_key.type()
        if kt in tamper and kt not in seen:
            seen.add(kt)
            sig = sig[:9] + bytes([sig[9] ^ 0x20]) + sig[10:]
        jsigs.append(jblock.CommitSig(jblock.BLOCK_ID_FLAG_COMMIT,
                                      v.address, ts, sig))
        tsigs.append(tblock.CommitSig(jblock.BLOCK_ID_FLAG_COMMIT,
                                      v.address,
                                      TTimestamp(ts.seconds, ts.nanos), sig))
    tbid = tblock.BlockID(bid.hash, tblock.PartSetHeader(
        bid.part_set_header.total, bid.part_set_header.hash))
    return (jblock.Commit(height, 0, bid, jsigs),
            tblock.Commit(height, 0, tbid, tsigs), bid, tbid)


def _outcome(fn):
    try:
        fn()
    except Exception as e:                        # noqa: BLE001
        return type(e).__name__, str(e), getattr(e, "failed_ctx", None)
    return None


def test_mixed_sets_batch_and_hash_as_jax():
    for privs in (_PRIVS, _PRIVS[:4], _PRIVS[4:]):
        jvals, tvals = _valsets(privs)
        jc, tc, _, _ = _commits(privs=privs)
        assert tval._should_batch_verify(tvals, tc) == \
            jval._should_batch_verify(jvals, jc) is True
        assert tvals.hash(device="cpu") == jvals.hash()
    jvals, tvals = _valsets()
    jc, tc, _, _ = _commits()
    one_j = jblock.Commit(HEIGHT, 0, jc.block_id, jc.signatures[:1])
    one_t = tblock.Commit(HEIGHT, 0, tc.block_id, tc.signatures[:1])
    assert tval._should_batch_verify(tvals, one_t) == \
        jval._should_batch_verify(jvals, one_j) is False


@pytest.mark.parametrize("fn, tamper", [
    ("verify_commit_light", ()),
    ("verify_commit", ("secp256k1",)),
])
def test_mixed_commit_matches_jax(_paths, fn, tamper):
    jvals, tvals = _valsets()
    jc, tc, bid, tbid = _commits(tamper)
    want = _outcome(lambda: getattr(jval, fn)(CHAIN_ID, jvals, bid, HEIGHT,
                                              jc))
    got = _outcome(lambda: getattr(tval, fn)(CHAIN_ID, tvals, tbid, HEIGHT,
                                             tc, device="cpu"))
    assert got == want
    assert (want is None) == (not tamper)
    if tamper:
        assert want[0] == "ErrInvalidSignature"
    assert sorted(set(_paths)) == ["CudaEd25519BatchVerifier",
                                   "CudaSecp256k1BatchVerifier"]


def test_deferred_window_blames_the_same_height(_paths):
    jvals, tvals = _valsets()
    jbatch, tbatch_ = jval.DeferredSigBatch(), tval.DeferredSigBatch()
    for h, tamper in ((HEIGHT, ()), (HEIGHT + 1, ("secp256k1",))):
        jc, tc, bid, tbid = _commits(tamper, height=h)
        jval.verify_commit_light(CHAIN_ID, jvals, bid, h, jc,
                                 defer_to=jbatch)
        tval.verify_commit_light(CHAIN_ID, tvals, tbid, h, tc,
                                 defer_to=tbatch_, device="cpu")
    assert tbatch_.count() == jbatch.count() == 10
    want = _outcome(jbatch.verify)
    got = _outcome(lambda: tbatch_.verify(device="cpu"))
    assert got == want
    assert want[0] == "ErrInvalidSignature" and want[2] == HEIGHT + 1
    assert sorted(set(_paths)) == ["CudaEd25519BatchVerifier",
                                   "CudaSecp256k1BatchVerifier"]


class _OtherKey:
    """A key type neither package batches: verified singly."""

    def __init__(self, ok):
        self.ok = ok

    def type(self):
        return "bls12_381"

    def bytes(self):
        return b"\x07" * 48

    def verify_signature(self, msg, sig):
        if self.ok is None:
            raise RuntimeError("backend unavailable")
        return self.ok


def test_mixed_batch_verifier_merges_in_insertion_order(_paths):
    ed_k, (s0, s1, s2) = _PRIVS[0], _PRIVS[4:]
    items = [(ed_k.pub_key(), b"a", ed_k.sign(b"a")),
             (s0.pub_key(), b"b", s0.sign(b"b")),
             (_OtherKey(True), b"c", b"sig"),
             (s1.pub_key(), b"d", s1.sign(b"OTHER")),
             (ed_k.pub_key(), b"e", ed_k.sign(b"e")),
             (_OtherKey(None), b"f", b"sig"),
             (s2.pub_key(), b"g", s2.sign(b"g"))]
    jv = jb.MixedBatchVerifier()
    tv = tbatch.MixedBatchVerifier(device="cpu")
    for pk, m, s in items:
        jv.add(pk, m, s)
        tv.add(pk if isinstance(pk, _OtherKey) else _port_key(pk), m, s)
    assert tv.count() == jv.count() == len(items)
    want = jv.verify()
    assert tv.verify() == want == (False, [True, True, True, False, True,
                                           False, True])
    assert sorted(_paths) == ["CudaEd25519BatchVerifier",
                              "CudaSecp256k1BatchVerifier"]
    assert tbatch.MixedBatchVerifier(device="cpu").verify() == \
        jb.MixedBatchVerifier().verify() == (False, [])
