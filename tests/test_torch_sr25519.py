"""sr25519 in the port (crypto/strobe.py, crypto/ristretto.py,
crypto/sr25519.py, the sr25519 verifiers of crypto/batch.py) against the
JAX package: the Keccak / STROBE / Merlin stack, ristretto255, keys,
signatures, challenges and Edwards inputs byte for byte, the verifiers'
verdicts on valid and hostile signatures, and commits of an sr25519 set
and of an ed25519 + secp256k1 + sr25519 set through every entry point,
outcome for outcome.

The port runs with device="cpu" (the plain versions of K1-K4 and K14)
and lowered device thresholds; the JAX package verifies on its host
loops with its signature cache off, so no XLA program compiles."""

import hashlib
import random

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import batch as jb
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import ristretto as jrst
from cometbft_tpu.crypto import secp256k1 as jsk
from cometbft_tpu.crypto import sigcache
from cometbft_tpu.crypto import sr25519 as jsr
from cometbft_tpu.crypto import strobe as jstrobe
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import canonical as jcanon
from cometbft_tpu.types import validation as jval
from cometbft_tpu.types.timestamp import Timestamp as JTimestamp
from cometbft_tpu.types.validator_set import (Validator as JValidator,
                                              ValidatorSet as JValidatorSet)
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import ed25519_ref as tref
from cometbft_tpu_torch.crypto import ristretto as trst
from cometbft_tpu_torch.crypto import secp256k1 as tsk
from cometbft_tpu_torch.crypto import sigcache as tsigcache
from cometbft_tpu_torch.crypto import sr25519 as tsr
from cometbft_tpu_torch.crypto import strobe as tstrobe
from cometbft_tpu_torch.ops import ed25519 as tdev
from cometbft_tpu_torch.types import block as tblock
from cometbft_tpu_torch.types import validation as tval
from cometbft_tpu_torch.types.timestamp import Timestamp as TTimestamp
from cometbft_tpu_torch.types.validator_set import (
    Validator as TValidator, ValidatorSet as TValidatorSet)

torch.set_num_threads(1)

CPU = torch.device("cpu")
CHAIN_ID = "torch-sr25519-chain"
HEIGHT = 31
L, P = tsr.L, tref.P


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


@pytest.fixture
def programs(monkeypatch):
    """JAX side: host loops, no verdict cache.  Port side: no verdict
    cache either, device thresholds low enough that a sub-batch of three
    signatures runs the device programs; count the RLC
    programs, the localizations and the verifier classes that ran.  (A
    sub-batch of one or two ed25519 signatures stays on the host loop:
    several plain programs in MixedBatchVerifier's threads contend for
    the interpreter and take many times their time alone.)"""
    monkeypatch.setattr(sigcache, "_enabled_override", False)
    monkeypatch.setattr(tsigcache, "_enabled_override", False)
    monkeypatch.setattr(jb, "DEVICE_THRESHOLD", 10 ** 9)
    monkeypatch.setattr(jb, "SECP_DEVICE_THRESHOLD", 10 ** 9)
    monkeypatch.setattr(tbatch, "DEVICE_THRESHOLD", 3)
    monkeypatch.setattr(tbatch, "SECP_DEVICE_THRESHOLD", 2)
    monkeypatch.setattr(tval.DeferredSigBatch, "DEVICE_THRESHOLD", 3)
    monkeypatch.delenv("COMETBFT_TPU_PROVIDER", raising=False)
    calls = {"rlc": 0, "persig": 0, "verifiers": []}
    rlc, persig = ted.rlc_verify, tdev.verify_kernel

    def rlc_spy(*a, **k):
        calls["rlc"] += 1
        return rlc(*a, **k)

    def persig_spy(*a, **k):
        calls["persig"] += 1
        return persig(*a, **k)

    monkeypatch.setattr(ted, "rlc_verify", rlc_spy)
    monkeypatch.setattr(tdev, "verify_kernel", persig_spy)
    for cls in (tbatch.CudaEd25519BatchVerifier,
                tbatch.CudaSecp256k1BatchVerifier,
                tbatch.CudaSr25519BatchVerifier):
        real = cls._verify_items

        def spy(self, real=real, name=cls.__name__):
            calls["verifiers"].append(name)
            return real(self)
        monkeypatch.setattr(cls, "_verify_items", spy)
    return calls


# -- Keccak-f[1600], STROBE-128, Merlin -----------------------------------------

def _sha3_256(perm, msg: bytes) -> bytes:
    """SHA3-256 of msg by a sponge over `perm` (rate 136 bytes)."""
    rate = 136
    padded = bytearray(msg) + b"\x06" + bytes(-(len(msg) + 1) % rate)
    padded[-1] |= 0x80
    lanes = [0] * 25
    for off in range(0, len(padded), rate):
        for i in range(rate // 8):
            lanes[i] ^= int.from_bytes(padded[off + 8 * i:off + 8 * i + 8],
                                       "little")
        perm(lanes)
    return b"".join(v.to_bytes(8, "little") for v in lanes)[:32]


def test_keccak_matches_hashlib_and_jax():
    rng = np.random.default_rng(19)
    for n in (0, 1, 135, 136, 137, 300):
        msg = rng.bytes(n)
        assert _sha3_256(tstrobe.keccak_f1600, msg) == \
            hashlib.sha3_256(msg).digest()
    for _ in range(4):
        lanes = [int(x) for x in rng.integers(0, 2 ** 63, 25, dtype=np.uint64)
                 * 2 + rng.integers(0, 2, 25, dtype=np.uint64)]
        assert tstrobe.keccak_f1600(list(lanes)) == \
            jstrobe.keccak_f1600(list(lanes))


def test_merlin_vector_and_clone():
    """merlin's transcript equivalence test (transcript.rs), clone
    independence, and seeded transcripts equal to the JAX package's."""
    t = tstrobe.Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8"
        "145aa640af6e9bca177c03c7efcf0615")
    t = tstrobe.Transcript(b"p")
    u = t.clone()
    t.append_message(b"a", b"x")
    u.append_message(b"a", b"y")
    assert t.challenge_bytes(b"c", 16) != u.challenge_bytes(b"c", 16)
    rng = random.Random(7)
    for n in (0, 5, 166, 167, 400):
        tt, jt = tstrobe.Transcript(b"seeded"), jstrobe.Transcript(b"seeded")
        for x in (tt, jt):
            x.append_message(b"m", random.Random(n).randbytes(n))
            x.append_u64(b"n", n)
        c = rng.randrange(1, 200)
        assert tt.clone().challenge_bytes(b"c", c) == \
            jt.clone().challenge_bytes(b"c", c)
        assert tt.challenge_bytes(b"d", 64) == jt.challenge_bytes(b"d", 64)


# -- ristretto255 --------------------------------------------------------------

RFC9496_SMALL = [
    "0000000000000000000000000000000000000000000000000000000000000000",
    "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76",
    "6a493210f7499cd17fecb510ae0cea23a110e8d5b901f8acadd3095c73a3b919",
]


def test_ristretto_small_multiples_and_round_trips():
    for k in range(16):
        p = tref.point_mul(k, trst.BASEPOINT)
        enc = trst.encode(p)
        assert enc == jrst.encode(p)
        if k < len(RFC9496_SMALL):
            assert enc.hex() == RFC9496_SMALL[k]
    rng = random.Random(96)
    for k in [rng.randrange(L) for _ in range(6)] + [L - 1, 2 ** 200 + 5]:
        p = tref.point_mul(k, trst.BASEPOINT)
        enc = trst.encode(p)
        q = trst.decode(enc)
        assert q == jrst.decode(enc) and trst.eq(p, q)
        assert trst.encode(q) == enc
        # a point off by 2- or 4-torsion is the same ristretto element
        for t in ((0, P - 1, 1, 0), (tref.SQRT_M1, 0, 1, 0)):
            pt = tref.point_add(p, t)
            assert trst.eq(p, pt) and trst.encode(pt) == enc


def test_ristretto_rejections_match_jax():
    bad = [(P + 2).to_bytes(32, "little"),          # s >= p
           P.to_bytes(32, "little"),                # s = p
           (3).to_bytes(32, "little"),              # negative (odd) s
           b"\xff" * 32,
           b"\x01" + bytes(31),                     # negative s = 1
           bytes(31)]                               # short
    rng = random.Random(5)
    for _ in range(40):                             # most fail a test
        bad.append(rng.randbytes(32))
    n_square_fail = 0
    for enc in bad:
        got, want = trst.decode(enc), jrst.decode(enc)
        assert got == want
        s = int.from_bytes(enc, "little") if len(enc) == 32 else None
        if got is None and s is not None and s < P and s % 2 == 0:
            n_square_fail += 1
    assert all(trst.decode(e) is None for e in bad[:6])
    assert n_square_fail > 0                        # the square test


# -- keys, signatures, challenges, Edwards inputs ------------------------------

def _pair(seed):
    return jsr.PrivKey.generate(seed), tsr.PrivKey.generate(seed)


def test_keys_signatures_and_challenges_match_jax():
    rng = random.Random(25519)
    for i in range(4):
        seed = rng.randbytes(32)
        jp, tp = _pair(seed)
        assert tp.bytes() == jp.bytes()
        assert tp.pub_key().bytes() == jp.pub_key().bytes()
        assert tp.pub_key().address() == jp.pub_key().address()
        assert tp.type() == tp.pub_key().type() == "sr25519"
        msg = rng.randbytes(1 + 40 * i)
        sig = tp.sign(msg)
        assert sig == jp.sign(msg) and sig[63] & 0x80
        pub = tp.pub_key().bytes()
        assert tsr.challenge_scalar(msg, pub, sig[:32]) == \
            jsr.challenge_scalar(msg, pub, sig[:32])
        assert tsr.to_edwards_inputs(pub, msg, sig) == \
            jsr.to_edwards_inputs(pub, msg, sig)
    with pytest.raises(ValueError):
        tsr.PrivKey.generate(b"short")
    with pytest.raises(ValueError):
        tsr.PubKey(b"\x00" * 31)


def _valid(i, msg=None):
    priv = tsr.PrivKey.generate(bytes([200 - i]) * 32)
    msg = msg if msg is not None else b"sr-hostile-%d" % i
    return priv.pub_key().bytes(), msg, priv.sign(msg)


def _with_s(sig, s):
    b = bytearray(sig[:32] + s.to_bytes(32, "little"))
    b[63] |= 0x80
    return bytes(b)


def _hostile():
    """(label, pub, msg, sig): valid signatures, then one of each hostile
    class."""
    out = [("valid %d" % i, *_valid(i)) for i in range(3)]
    pub, msg, sig = _valid(3)
    other_pub = _valid(4)[0]
    s = int.from_bytes(sig[32:63] + bytes([sig[63] & 0x7F]), "little")
    non_square = next(
        e for e in (k.to_bytes(32, "little") for k in range(2, 400, 2))
        if jrst.decode(e) is None)
    k = 123456789
    out += [
        ("no marker", pub, msg, sig[:63] + bytes([sig[63] & 0x7F])),
        ("s = L - 1", pub, msg, _with_s(sig, L - 1)),
        ("s = L", pub, msg, _with_s(sig, L)),
        ("s >= L", pub, msg, _with_s(sig, L + s)),
        ("R: s >= p", pub, msg, (P + 4).to_bytes(32, "little") + sig[32:]),
        ("R: negative", pub, msg, (5).to_bytes(32, "little") + sig[32:]),
        ("R: not square", pub, msg, non_square + sig[32:]),
        ("R corrupted", pub, msg, sig[:3] + bytes([sig[3] ^ 4]) + sig[4:]),
        ("pub: s >= p", (P + 6).to_bytes(32, "little"), msg, sig),
        ("pub: negative", (7).to_bytes(32, "little"), msg, sig),
        ("pub: not square", non_square, msg, sig),
        ("wrong message", pub, msg + b"?", sig),
        ("another key", other_pub, msg, sig),
        ("short signature", pub, msg, sig[:63]),
        # the identity key: s*B = R + k*0 holds for R = sB
        ("identity key", bytes(32), msg,
         _with_s(trst.encode(tref.point_mul(k, tref.B)), k)),
        ("identity R", pub, msg, _with_s(bytes(32), 0)),
    ]
    return out


def test_hostile_inputs_match_jax():
    for label, pub, msg, sig in _hostile():
        assert tsr.to_edwards_inputs(pub, msg, sig) == \
            jsr.to_edwards_inputs(pub, msg, sig), label
        if len(pub) == 32:
            want = jsr.PubKey(pub).verify_signature(msg, sig)
            assert tsr.PubKey(pub).verify_signature(msg, sig) == want, label
            assert want == (label.startswith("valid")
                            or label == "identity key"), label


def test_cpu_verifier_matches_jax(programs):
    items = [x[1:] for x in _hostile()]
    tv = tbatch.create_batch_verifier("sr25519", provider="cpu", device=CPU)
    jv = jb.create_batch_verifier("sr25519", provider="cpu")
    assert isinstance(tv, tbatch.CpuSr25519BatchVerifier)
    for it in items:
        tv.add(*it)
        jv.add(*it)
    assert tv.verify() == jv.verify()
    assert programs["rlc"] == programs["persig"] == 0


def test_device_verifier_verdicts_and_programs(programs):
    """The plain K1-K4 and K1 + K14, verdict for verdict the host's
    PubKey.verify_signature: the whole hostile batch holds structural
    rejects (no RLC program, one localization); its signatures that pass
    the structural checks take one RLC program and one localization; the
    valid ones one RLC program."""
    cases = _hostile()
    structural = [tsr.to_edwards_inputs(p, m, s) is None
                  for _, p, m, s in cases]
    runs = [(cases, (0, 1)),
            ([c for c, x in zip(cases, structural) if not x], (1, 1))]
    for batch, (rlc, persig) in runs:
        want = [tsr.PubKey(p).verify_signature(m, s) for _, p, m, s in batch]
        assert not all(want)
        before = programs["rlc"], programs["persig"]
        bv = tbatch.create_batch_verifier("sr25519", n_hint=len(batch),
                                          device=CPU)
        assert isinstance(bv, tbatch.CudaSr25519BatchVerifier)
        for _, p, m, s in batch:
            bv.add(tsr.PubKey(p), m, s)
        assert bv.verify() == (False, want)
        assert (programs["rlc"] - before[0],
                programs["persig"] - before[1]) == (rlc, persig)
    clean = [c for c in cases if tsr.PubKey(c[1]).verify_signature(*c[2:])]
    bv = tbatch.CudaSr25519BatchVerifier(CPU)
    for _, p, m, s in clean:
        bv.add(p, m, s)
    assert bv.verify() == (True, [True] * len(clean))
    assert (programs["rlc"], programs["persig"]) == (2, 2)
    assert tbatch.CudaSr25519BatchVerifier(CPU).verify() == (False, [])


def test_routing_and_no_card(monkeypatch):
    assert tbatch.supports_batch_verifier("sr25519")
    assert isinstance(tbatch.create_batch_verifier("sr25519", n_hint=7,
                                                   device="cpu"),
                      tbatch.CpuSr25519BatchVerifier)
    assert isinstance(tbatch.create_batch_verifier("sr25519", n_hint=8,
                                                   device="cpu"),
                      tbatch.CudaSr25519BatchVerifier)
    assert type(jb.create_batch_verifier("sr25519", n_hint=7)).__name__ == \
        "CpuSr25519BatchVerifier"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatch.create_batch_verifier("sr25519")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatch.MixedBatchVerifier()


# -- commits: an sr25519 set and a three-type set -----------------------------

def _sr_privs(n, base):
    return [jsr.PrivKey.generate(bytes([base + i]) * 32) for i in range(n)]


def _ed_privs(n, base):
    return [jed.PrivKey.generate(bytes([base + i]) * 32) for i in range(n)]


def _secp_privs(n, base):
    return [jsk.PrivKey.generate(bytes([base + i]) * 32) for i in range(n)]


SR_PRIVS = _sr_privs(7, 60)
# the three-type set of the commits: its lone ed25519 key goes to the host
# loop (a sub-batch below the device threshold), its sr25519 and
# secp256k1 keys to the device programs; tests/test_torch_mixed.py runs
# ed25519's device program in mixed commits
COMMIT_MIXED = _sr_privs(4, 80) + _ed_privs(1, 90) + _secp_privs(3, 110)


def _port_key(pub):
    mod = {"ed25519": ted, "secp256k1": tsk, "sr25519": tsr}[pub.type()]
    return mod.PubKey(pub.bytes())


def _valsets(privs):
    jvals = JValidatorSet([JValidator(p.pub_key(), 10) for p in privs])
    tvals = TValidatorSet([TValidator(_port_key(p.pub_key()), 10)
                           for p in privs])
    assert [v.address for v in jvals.validators] == \
        [v.address for v in tvals.validators]
    return jvals, tvals


def _commits(privs, tamper=(), height=HEIGHT):
    """The same all-COMMIT commit in both packages; tamper names the key
    types whose first signer's signature gets a flipped bit in its s half
    (a flipped R of sr25519 would mostly fail to decode: a structural
    reject, with no RLC program).  Returns the commits, the block IDs
    and the tampered indices."""
    jvals, _ = _valsets(privs)
    by_addr = {p.pub_key().address(): p for p in privs}
    bid = jblock.BlockID(b"\x31" * 32, jblock.PartSetHeader(1, b"\x32" * 32))
    jsigs, tsigs, bad = [], [], []
    for i, v in enumerate(jvals.validators):
        ts = JTimestamp(1_700_000_000 + i, 1000 * i)
        sb = jcanon.vote_sign_bytes(CHAIN_ID, 2, height, 0, bid, ts)
        sig = by_addr[v.address].sign(sb)
        kt = v.pub_key.type()
        if kt in tamper and all(jvals.validators[j].pub_key.type() != kt
                                for j in bad):
            bad.append(i)
            sig = sig[:40] + bytes([sig[40] ^ 0x20]) + sig[41:]
        jsigs.append(jblock.CommitSig(jblock.BLOCK_ID_FLAG_COMMIT,
                                      v.address, ts, sig))
        tsigs.append(tblock.CommitSig(jblock.BLOCK_ID_FLAG_COMMIT,
                                      v.address,
                                      TTimestamp(ts.seconds, ts.nanos), sig))
    tbid = tblock.BlockID(bid.hash, tblock.PartSetHeader(
        bid.part_set_header.total, bid.part_set_header.hash))
    return (jblock.Commit(height, 0, bid, jsigs),
            tblock.Commit(height, 0, tbid, tsigs), bid, tbid, bad)


def _outcome(fn):
    try:
        fn()
    except Exception as e:                        # noqa: BLE001
        return type(e).__name__, str(e), getattr(e, "failed_ctx", None)
    return None


def _entry_points(privs, jc, tc, jbid, tbid):
    jvals, tvals = _valsets(privs)

    def deferred(validation, vals, commit, bid, **kw):
        def run():
            batch = validation.DeferredSigBatch()
            validation.verify_commit_light(CHAIN_ID, vals, bid, HEIGHT,
                                           commit, defer_to=batch, **kw)
            batch.verify(**kw)
        return run

    return {
        "verify_commit": (
            lambda: jval.verify_commit(CHAIN_ID, jvals, jbid, HEIGHT, jc),
            lambda: tval.verify_commit(CHAIN_ID, tvals, tbid, HEIGHT, tc,
                                       device=CPU)),
        "verify_commit_light": (
            lambda: jval.verify_commit_light(CHAIN_ID, jvals, jbid, HEIGHT,
                                             jc),
            lambda: tval.verify_commit_light(CHAIN_ID, tvals, tbid, HEIGHT,
                                             tc, device=CPU)),
        "verify_commit_light_trusting": (
            lambda: jval.verify_commit_light_trusting(
                CHAIN_ID, jvals, jc, jval.Fraction(1, 3)),
            lambda: tval.verify_commit_light_trusting(
                CHAIN_ID, tvals, tc, tval.Fraction(1, 3), device=CPU)),
        "deferred": (deferred(jval, jvals, jc, jbid),
                     deferred(tval, tvals, tc, tbid, device=CPU)),
    }


@pytest.mark.parametrize("set_name, tamper", [
    ("sr25519", ()), ("sr25519", ("sr25519",)),
    ("mixed", ()), ("mixed", ("sr25519", "ed25519", "secp256k1")),
])
def test_commit_outcomes_match_jax(programs, set_name, tamper):
    privs = SR_PRIVS if set_name == "sr25519" else COMMIT_MIXED
    jc, tc, jbid, tbid, bad = _commits(privs, tamper)
    assert len(bad) == len(tamper)
    for name, (jfn, tfn) in _entry_points(privs, jc, tc, jbid,
                                          tbid).items():
        want, got = _outcome(jfn), _outcome(tfn)
        assert got == want, (set_name, tamper, name)
        if not tamper:
            assert want is None
        elif name == "verify_commit":
            assert want[0] == "ErrInvalidSignature" and \
                want[1].startswith(f"wrong signature (#{min(bad)}): ")
    assert "CudaSr25519BatchVerifier" in programs["verifiers"]
    if set_name == "mixed":
        assert "CudaSecp256k1BatchVerifier" in programs["verifiers"]
    # light verification stops past +2/3: in the mixed set some of its
    # sr25519 sub-batches are below the device threshold
    assert programs["rlc"] >= (4 if set_name == "sr25519" else 1)
    if tamper:
        assert programs["persig"] >= 1


def test_deferred_window_blames_the_same_height(programs):
    jvals, tvals = _valsets(COMMIT_MIXED)
    jbatch, tbatch_ = jval.DeferredSigBatch(), tval.DeferredSigBatch()
    for h, tamper in ((HEIGHT, ()), (HEIGHT + 1, ("sr25519",))):
        jc, tc, bid, tbid, _ = _commits(COMMIT_MIXED, tamper, height=h)
        jval.verify_commit_light(CHAIN_ID, jvals, bid, h, jc,
                                 defer_to=jbatch)
        tval.verify_commit_light(CHAIN_ID, tvals, tbid, h, tc,
                                 defer_to=tbatch_, device=CPU)
    assert tbatch_.count() == jbatch.count()
    want = _outcome(jbatch.verify)
    got = _outcome(lambda: tbatch_.verify(device=CPU))
    assert got == want
    assert want[0] == "ErrInvalidSignature" and want[2] == HEIGHT + 1
    assert "CudaSr25519BatchVerifier" in programs["verifiers"]


def test_mixed_batch_verifier_three_types(programs):
    """Every type on its device program (provider "tpu"), one bad
    sr25519 and one bad secp256k1 signature."""
    privs = _sr_privs(3, 80) + _ed_privs(2, 90) + _secp_privs(2, 110)
    items = []
    for i, p in enumerate(privs):
        m = b"three-types-%d" % i
        sig = p.sign(m)
        if i in (1, 6):
            m += b"!"
        items.append((p.pub_key(), m, sig))
    jv = jb.MixedBatchVerifier()
    tv = tbatch.MixedBatchVerifier(provider="tpu", device=CPU)
    for pk, m, s in items:
        jv.add(pk, m, s)
        tv.add(_port_key(pk), m, s)
    want = jv.verify()
    assert tv.verify() == want == (False, [i not in (1, 6)
                                           for i in range(len(items))])
    assert sorted(programs["verifiers"]) == [
        "CudaEd25519BatchVerifier", "CudaSecp256k1BatchVerifier",
        "CudaSr25519BatchVerifier"]


def test_validator_set_hash_refuses_sr25519_as_jax():
    jvals, tvals = _valsets(SR_PRIVS[:2])
    with pytest.raises(ValueError) as jerr:
        jvals.hash()
    with pytest.raises(ValueError) as terr:
        tvals.hash(device="cpu")
    assert str(terr.value) == str(jerr.value) == \
        "unsupported pubkey type sr25519"
