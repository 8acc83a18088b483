"""The port's BLS12-381 keys (crypto/bls12381.py) against the JAX
package's wrapper and the pure-Python RFC 9380 reference (bls_ref.py) on
the CPU.  The port compiles native/bls12381/bls.cc with g++ into its own
build directory (ops/build/) and loads only that library; the module
skips where g++ is absent, as tests/test_bls12381.py does.  The JAX
wrapper is pointed at the same compiled library here (its own build
writes into native/, which tests/test_bls12381.py may be compiling in
another worker at the same time), so the comparison holds the port's
Python layer (pre-hashing, length rules, aggregation, the gate) against
the JAX package's, and both against the goldens."""

import hashlib

import pytest
import torch

from cometbft_tpu.crypto import bls12381 as jbls
from cometbft_tpu.types import validator_set as jvset
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import bls12381 as tbls
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import encoding as tenc
from cometbft_tpu_torch.crypto import sigcache
from cometbft_tpu_torch.types import validator_set as tvset

RO_DST = b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_"


@pytest.fixture(scope="module", autouse=True)
def built():
    if not tbls.enabled():
        pytest.skip("g++ unavailable; bls12381 stays gated off")
    saved = jbls._LIB_PATH, jbls._lib
    jbls._LIB_PATH, jbls._lib = str(tbls.library_path()), None
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    jbls._LIB_PATH, jbls._lib = saved
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cache():
    sigcache.reset()
    sigcache.set_enabled(None)
    yield
    sigcache.reset()


def test_library_is_the_ports_own():
    assert tbls.enabled()
    path = tbls.library_path()
    assert path.parent == tbls.BUILD_DIR
    assert path.parent.name == "build" and path.parent.parent.name == "ops"
    assert tbls._load()._name == str(path)
    assert "native" not in path.parts


def _pair(seed):
    return (jbls.PrivKey.generate(seed), tbls.PrivKey.generate(seed))


def test_keys_sign_verify_match_jax():
    msgs = [b"", b"short", b"m" * 32, b"tendermint over bls, past MaxMsgLen",
            bytes(range(200))]
    for i in range(3):
        jk, tk = _pair(bytes([i + 1]) * 32)
        assert tk.data == jk.data
        jp, tp = jk.pub_key(), tk.pub_key()
        assert (tp.bytes(), tp.address(), tp.type()) == \
            (jp.bytes(), jp.address(), jp.type())
        assert tp.validate() == jp.validate() is True
        for m in msgs:
            sig = tk.sign(m)
            assert sig == jk.sign(m)
            assert tp.verify_signature(m, sig) == jp.verify_signature(m, sig)
            bad = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
            assert tp.verify_signature(m, bad) == \
                jp.verify_signature(m, bad) is False
            assert tp.verify_signature(m, sig[:-1]) is False
    # short messages: signable, never verifiable; 32 bytes verified raw
    jk, tk = _pair(b"\x0c" * 32)
    assert not tk.pub_key().verify_signature(b"short", tk.sign(b"short"))
    m32 = b"m" * 32
    assert tk.pub_key().verify_signature(m32, tk.sign(m32))
    long_msg = b"q" * 200
    assert tk.sign(long_msg) == tk.sign(hashlib.sha256(long_msg).digest())
    assert tk.sign(m32) != tk.sign(hashlib.sha256(m32).digest())


def test_aggregate_match_jax():
    msg = b"aggregate me (padded past MaxMsgLen)"
    pairs = [_pair(bytes([i + 1]) * 32) for i in range(4)]
    sigs = [t.sign(msg) for _, t in pairs]
    pks = [t.pub_key().bytes() for _, t in pairs]
    agg_sig = tbls.aggregate_signatures(sigs)
    agg_pk = tbls.aggregate_pubkeys(pks)
    assert agg_sig == jbls.aggregate_signatures(sigs)
    assert agg_pk == jbls.aggregate_pubkeys(pks)
    assert tbls.PubKey(agg_pk).verify_signature(msg, agg_sig)
    assert not tbls.PubKey(tbls.aggregate_pubkeys(pks[:3])).verify_signature(
        msg, agg_sig)
    for fn, arg in ((tbls.aggregate_signatures, [sigs[0][:-1]]),
                    (tbls.aggregate_pubkeys, [pks[0] + b"\x00"])):
        with pytest.raises(ValueError) as te:
            fn(arg)
        with pytest.raises(ValueError) as je:
            getattr(jbls, fn.__name__)(arg)
        assert str(te.value) == str(je.value)


def test_rfc9380_vectors_and_python_oracle():
    """RFC 9380 Appendix K (expand_message_xmd K.1, hash_to_curve G2 RO
    for msg = ''), then the pure-Python reference on other inputs."""
    import bls_ref as B

    dst = b"QUUX-V01-CS02-with-expander-SHA256-128"
    assert tbls.expand_message_xmd(b"", dst, 32).hex() == (
        "68a985b87eb6b46952128911f2a4412bbc302a9d759667f87f7a21d803f07235")
    for m, n in ((b"msg", 96), (b"abc", 128)):
        assert tbls.expand_message_xmd(m, b"DST-A", n) == \
            jbls.expand_message_xmd(m, b"DST-A", n) == \
            B.expand_message_xmd(m, b"DST-A", n)

    def compress(pt):
        (xc0, xc1), (yc0, yc1) = pt
        out = bytearray(xc1.to_bytes(48, "big") + xc0.to_bytes(48, "big"))
        out[0] |= 0x80
        half = (B.P - 1) // 2
        if yc1 > half or (yc1 == 0 and yc0 > half):
            out[0] |= 0x20
        return bytes(out)

    x_c0 = 0x0141ebfbdca40eb85b87142e130ab689c673cf60f1a3e98d69335266f30d9b8d4ac44c1038e9dcdd5393faf5c41fb78a
    x_c1 = 0x05cb8437535e20ecffaef7752baddf98034139c38452458baeefab379ba13dff5bf5dd71b72418717047f5b0f37da03d
    y_c0 = 0x0503921d7f6a12805e72940b963c0cf3471c7b2a524950ca195d11062ee75ec076daf2d4bc358c4b190c0c98064fdd92
    y_c1 = 0x12424ac32561493f3fe3c260708a12b7c620e7be00099a974e259ddc7d1f6395c3c811cdd19f1e8dbf3e9ecfdcbab8d6
    assert tbls.hash_to_g2(b"", RO_DST) == compress(((x_c0, x_c1),
                                                     (y_c0, y_c1)))
    for msg, d in ((b"abc", RO_DST), (b"m", b"COMETBFT-TPU-TEST-DST")):
        assert tbls.hash_to_g2(msg, d) == jbls.hash_to_g2(msg, d) == \
            compress(B.hash_to_g2(msg, d))


def test_gate_without_the_library(monkeypatch):
    """No library: enabled() is False and signing or verifying raises;
    a key still decodes, hashes and addresses from its bytes."""
    priv = tbls.PrivKey.generate(b"\x05" * 32)
    pub = priv.pub_key()
    sig = priv.sign(b"x" * 40)
    monkeypatch.setattr(tbls, "_lib", None)
    monkeypatch.setattr(tbls, "_failed", "g++ not found")
    assert tbls.enabled() is False
    with pytest.raises(RuntimeError, match="not enabled: g.. not found"):
        pub.verify_signature(b"x" * 40, sig)
    with pytest.raises(RuntimeError):
        tbls.PrivKey.generate(b"\x05" * 32)
    key = tenc.pubkey_from_proto(tenc.pubkey_to_proto(pub))
    assert key.bytes() == pub.bytes() and key.address() == pub.address()
    # a host verify loop maps the raise to an invalid signature
    assert tbatch.safe_verify(key, b"x" * 40, sig) is False


def test_bls_validators_and_mixed_batch():
    """A bls12_381 validator in a set hashes as in the JAX package, and
    MixedBatchVerifier verifies it singly beside a batched ed25519 key."""
    jk, tk = _pair(b"\x06" * 32)
    jv = jvset.ValidatorSet([jvset.Validator(jk.pub_key(), 10)])
    tv = convert.validator_set_from_proto(jv)
    assert tv.hash(device="cpu") == jv.hash()
    assert isinstance(tv.validators[0].pub_key, tbls.PubKey)
    idx, val = tv.get_by_address(tk.pub_key().address())
    assert idx == 0 and val.voting_power == 10
    ek = ted.PrivKey.generate(b"\x0a" * 32)
    m1, m2 = b"m1" * 16, b"m2" * 16
    for bad, want in ((False, [True, True]), (True, [False, True])):
        mv = tbatch.MixedBatchVerifier(device="cpu")
        mv.add(tk.pub_key(), m1, tk.sign(b"WRONG" * 8 if bad else m1))
        mv.add(ek.pub_key(), m2, ek.sign(m2))
        ok, verdicts = mv.verify()
        assert verdicts == want and ok == (not bad)
