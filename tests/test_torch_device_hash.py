"""The port's device-hash verify path on the CPU, against the JAX package
and against Python integers, hashlib and the pure-Python oracle.

Covers ops/limbs.py and ops/scalar25519.py (radix-2**16 limbs, Barrett
reduction mod L), each sub-function of ops/ed25519's device-hash
programs (_h_scalars, _zh_mod_l, _segment_sum_mod_l, _add_mod_l,
_recode_w5_device), the device-hash packers byte for byte, the verdicts
of crypto/batch._device_verify_hash(device="cpu") and the split over a
device list, and ValidatorSet.hash() / bulk SHA-256 through
crypto/merkle.py and crypto/hash.py.  The JAX whole programs
(rlc_verify_hash_kernel, verify_hash_kernel) are minutes of XLA compile
and run under -m slow."""

import gc
import hashlib
import importlib
import importlib.util
import random
import secrets
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import cometbft_tpu
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import hash as jhash
from cometbft_tpu.crypto import merkle as jmerkle
from cometbft_tpu.ops import ed25519 as jdev
from cometbft_tpu.ops import limbs as jlb
from cometbft_tpu.ops import scalar25519 as jsc
from cometbft_tpu.ops import sha2 as jsha2
from cometbft_tpu.types import validator_set as jvs
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import ed25519_ref as tref
from cometbft_tpu_torch.crypto import hash as thash
from cometbft_tpu_torch.crypto import merkle as tmerkle
from cometbft_tpu_torch.crypto import mesh as tmesh
from cometbft_tpu_torch.ops import ed25519 as tdev
from cometbft_tpu_torch.ops import limbs as lb
from cometbft_tpu_torch.ops import scalar25519 as sc
from cometbft_tpu_torch.ops import sha2
from cometbft_tpu_torch.types import validator_set as tvs

torch.set_num_threads(1)   # many small ops; no OpenMP spin beside busy workers

L = sc.L
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _frozen_heap():
    """After each test's own objects are collected, the heap is frozen
    for the next: the per-test gc.collect() of the leak checks walks only
    what one test made.  Unfrozen at the module's end."""
    yield
    gc.unfreeze()


@pytest.fixture(autouse=True)
def _freeze_heap():
    gc.freeze()


def _int(row) -> int:
    return lb.limbs_to_int(np.asarray(row))


def _rows(vals, n):
    """Python ints -> (len, n) int64 limb tensor and uint32 numpy."""
    arr = np.stack([lb.int_to_limbs(v, n) for v in vals])
    return torch.from_numpy(arr.astype(np.int64)), arr


def _np(t):
    return np.asarray(t).astype(np.int64)


# -- limbs and Barrett --------------------------------------------------------

def test_limb_ops_match_jax_and_ints():
    rng = random.Random(1)
    av = [0, 1, (1 << 272) - 1] + [rng.getrandbits(272) for _ in range(13)]
    bv = [(1 << 272) - 1, 0, (1 << 272) - 1] + \
        [rng.getrandbits(rng.choice((8, 200, 272))) for _ in range(13)]
    a, an = _rows(av, 17)
    b, bn = _rows(bv, 17)
    np.testing.assert_array_equal(_np(lb.mul_raw(a, b)),
                                  _np(jlb.mul_raw(an, bn)))
    prod = lb.mul(a, b)
    np.testing.assert_array_equal(_np(prod), _np(jlb.mul(an, bn)))
    assert [_int(r) for r in prod] == [x * y for x, y in zip(av, bv)]
    np.testing.assert_array_equal(lb.ge(a, b).numpy(),
                                  np.asarray(jlb.ge(an, bn)))
    assert lb.ge(a, b).tolist() == [x >= y for x, y in zip(av, bv)]
    np.testing.assert_array_equal(_np(lb.cond_sub(a, b)),
                                  _np(jlb.cond_sub(an, bn)))
    assert [_int(r) for r in lb.cond_sub(a, b)] == \
        [x - y if x >= y else x for x, y in zip(av, bv)]
    np.testing.assert_array_equal(_np(lb.sub_exact(a, b)),
                                  _np(jlb.sub_exact(an, bn)))
    # limbs up to 2**31: the JAX package's uint32 carry sweep would wrap
    # near 2**32
    wide = np.random.default_rng(2).integers(0, 1 << 31, (6, 20),
                                             dtype=np.uint64)
    got, carry = lb.carry_prop(torch.from_numpy(wide.astype(np.int64)))
    want, wcarry = jlb.carry_prop(wide.astype(np.uint32))
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(carry), _np(wcarry))
    words = wide[:, :8]
    np.testing.assert_array_equal(
        _np(lb.words32_to_limbs(torch.from_numpy(words.astype(np.int64)))),
        _np(jlb.words32_to_limbs(words.astype(np.uint32))))
    assert lb.int_to_limbs(L, 16).tobytes() == \
        jlb.int_to_limbs(L, 16).tobytes()


def test_barrett_matches_jax_and_ints():
    rng = random.Random(3)
    vals = [0, 1, L - 1, L, 2 * L, 3 * L + 5, (1 << 512) - 1,
            ((1 << 512) // L) * L, ((1 << 512) // L) * L - 1] + \
        [rng.getrandbits(512) for _ in range(23)]
    x, xn = _rows(vals, 32)
    got = sc.barrett_reduce_wide(x)
    np.testing.assert_array_equal(_np(got),
                                  _np(jsc.barrett_reduce_wide(xn)))
    assert [_int(r) for r in got] == [v % L for v in vals]


def test_digest_to_wide_limbs_matches_jax():
    rng = np.random.default_rng(4)
    hi = rng.integers(0, 1 << 32, (5, 8), dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, (5, 8), dtype=np.uint64).astype(np.uint32)
    got = sc.digest512_to_wide_limbs(torch.from_numpy(hi.view(np.int32)),
                                     torch.from_numpy(lo.view(np.int32)))
    np.testing.assert_array_equal(_np(got),
                                  _np(jsc.digest512_to_wide_limbs(hi, lo)))
    for i in range(5):
        digest = sha2.digest512_to_bytes(hi[i], lo[i])
        assert _int(got[i]) == int.from_bytes(digest, "little")


# -- the device-hash sub-functions --------------------------------------------

# R||A||M lengths at SHA-512's padding boundaries
RAM_SIZES = [64, 111, 112, 127, 128, 200, 239, 240]


def test_h_scalars_match_hashlib_and_jax():
    rng = random.Random(5)
    msgs = [rng.randbytes(s) for s in RAM_SIZES]
    hi, lo, nb = sha2.pad_sha512(msgs, 3)
    nb[-1] = 0                              # a filler row
    got = tdev._h_scalars(convert.words_from_numpy(hi, CPU),
                          convert.words_from_numpy(lo, CPU),
                          torch.from_numpy(nb))
    np.testing.assert_array_equal(
        _np(got), _np(jax.jit(jdev._h_scalars)(hi, lo, nb)))
    for i, m in enumerate(msgs[:-1]):
        assert _int(got[i]) == int.from_bytes(
            hashlib.sha512(m).digest(), "little") % L, len(m)


def test_zh_mod_l_matches_jax_and_ints():
    rng = random.Random(6)
    zv = [0, (1 << 128) - 1] + [rng.getrandbits(128) | (1 << 127)
                                for _ in range(10)]
    hv = [L - 1, L - 1] + [rng.randrange(L) for _ in range(10)]
    z, zn = _rows(zv, 8)
    h, hn = _rows(hv, 16)
    got = tdev._zh_mod_l(z, h)
    np.testing.assert_array_equal(_np(got), _np(jdev._zh_mod_l(zn, hn)))
    assert [_int(r) for r in got] == [a * b % L for a, b in zip(zv, hv)]


@pytest.mark.parametrize("n", [24, 70_000])
def test_segment_sum_matches_jax_and_ints(n):
    """Past N = 65,536 a 16-bit-limb scatter overflows uint32; the port's
    int64 columns must still give the canonical sum mod L."""
    k = 7
    rng = np.random.default_rng(n)
    zh = rng.integers(0, 1 << 16, (n, 16)).astype(np.uint32)
    zh[:, 15] &= 0x0FFF                     # every row < 2**252 < L
    zh[: n // 2] = lb.int_to_limbs(L - 1, 16)   # and many at L - 1
    gids = rng.integers(0, k, n).astype(np.int32)
    got = tdev._segment_sum_mod_l(torch.from_numpy(zh.astype(np.int64)),
                                  torch.from_numpy(gids), k)
    want = jax.jit(jdev._segment_sum_mod_l, static_argnums=2)(zh, gids, k)
    np.testing.assert_array_equal(_np(got), _np(want))
    vals = [int.from_bytes(r.astype("<u2").tobytes(), "little") for r in zh]
    sums = [0] * k
    for v, g in zip(vals, gids):
        sums[g] += v
    assert [_int(r) for r in got] == [s % L for s in sums]


def test_add_mod_l_matches_jax_and_ints():
    rng = random.Random(8)
    pairs = [(0, 0), (L - 1, L - 1), (L - 1, 1), (L - 1, 0)] + \
        [(rng.randrange(L), rng.randrange(L)) for _ in range(8)]
    a, an = _rows([x for x, _ in pairs], 16)
    b, bn = _rows([y for _, y in pairs], 16)
    got = tdev._add_mod_l(a, b)
    np.testing.assert_array_equal(_np(got), _np(jdev._add_mod_l(an, bn)))
    assert [_int(r) for r in got] == [(x + y) % L for x, y in pairs]


def test_recode_w5_device_matches_host_and_jax():
    rng = random.Random(9)
    vals = [0, 1, 15, 16, 31, 32, L - 1, L // 2] + \
        [rng.randrange(L) for _ in range(24)]
    s, sn = _rows(vals, 16)
    mag, neg = tdev._recode_w5_device(s)
    hm, hn = ted._recode_w5(vals, ted.NDIG_256, len(vals))
    assert mag.dtype == torch.int32 and neg.dtype == torch.bool
    np.testing.assert_array_equal(mag.numpy(), hm)
    np.testing.assert_array_equal(neg.numpy(), hn)
    jm, jn = jdev._recode_w5_device(sn)
    np.testing.assert_array_equal(mag.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(neg.numpy(), np.asarray(jn))


# -- the packers --------------------------------------------------------------

def _signed(n, seed=5, dup=None, sizes=None):
    """n (pk, msg, sig); `dup` maps an index to the index whose key it
    reuses; `sizes` sets message lengths by index."""
    privs = [ted.PrivKey.generate(bytes([seed, i]) + b"\x07" * 30)
             for i in range(n)]
    for i, j in (dup or {}).items():
        privs[i] = privs[j]
    pks, msgs, sigs = [], [], []
    for i, p in enumerate(privs):
        m = b"devhash-" + bytes([i]) * 40
        if sizes and i in sizes:
            m = bytes([i]) * sizes[i]
        pks.append(p.pub_key().bytes())
        msgs.append(m)
        sigs.append(p.sign(m))
    return pks, msgs, sigs


@pytest.fixture
def pinned_z(monkeypatch):
    """secrets.token_bytes made deterministic, for both packages."""
    monkeypatch.setattr(secrets, "token_bytes",
                        lambda k: random.Random(99).randbytes(k))


PACK_CASES = {
    "distinct": dict(n=6),
    "repeated": dict(n=9, dup={3: 0, 5: 0, 8: 2}),
    "ragged": dict(n=5, dup={4: 1}, sizes={0: 0, 2: 47, 3: 48, 4: 111}),
}


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_rlc_device_hash_matches_jax(pinned_z, case):
    pks, msgs, sigs = _signed(**PACK_CASES[case])
    _same(ted.pack_rlc_device_hash(pks, msgs, sigs),
          jed.pack_rlc_device_hash(pks, msgs, sigs))
    # callers that parsed ahead pass placeholder sigs
    parsed = ted.parse_batch(pks, sigs)
    assert parsed == jed.parse_batch(pks, sigs)
    n = len(pks)
    _same(ted.pack_rlc_device_hash(pks, msgs, [b""] * n, parsed=parsed),
          jed.pack_rlc_device_hash(pks, msgs, [b""] * n, parsed=parsed))


def test_pack_rlc_device_hash_refusals(pinned_z):
    pks, msgs, sigs = _signed(4)
    bad = list(sigs)
    bad[1] = bad[1][:32] + (L + 3).to_bytes(32, "little")
    assert ted.pack_rlc_device_hash(pks, msgs, bad) is None
    assert jed.pack_rlc_device_hash(pks, msgs, bad) is None
    assert ted.pack_rlc_device_hash([], [], []) is None
    long = list(msgs)
    long[2] = b"x" * (3 * 128 - 64 - 16)
    for pack in (ted.pack_rlc_device_hash, jed.pack_rlc_device_hash):
        with pytest.raises(ValueError, match="message exceeds max_blocks"):
            pack(pks, long, sigs)


def test_pack_batch_device_hash_matches_jax():
    pks, msgs, sigs = _signed(5, dup={3: 1}, sizes={2: 150})
    sigs[4] = b"\xff" * 64                      # structural reject
    _same(ted.pack_batch_device_hash(pks, msgs, sigs, 16),
          jed.pack_batch_device_hash(pks, msgs, sigs, 16))
    long = list(msgs)
    long[0] = b"y" * 400
    for pack in (ted.pack_batch_device_hash, jed.pack_batch_device_hash):
        with pytest.raises(ValueError, match="message exceeds max_blocks"):
            pack(pks, long, sigs, 16)


def test_device_hash_knobs_read_as_jax(monkeypatch):
    """COMETBFT_TPU_DEVICE_HASH_BLOCKS and COMETBFT_TPU_HASH_THRESHOLD
    are read at import, in both packages."""
    monkeypatch.setenv("COMETBFT_TPU_DEVICE_HASH_BLOCKS", "5")
    monkeypatch.setenv("COMETBFT_TPU_HASH_THRESHOLD", "77")
    path = Path(cometbft_tpu.__file__).parent
    # a reload makes new classes (PubKey, ...); modules that imported the
    # first ones, and libs/tmjson's key registry, still hold those: they
    # are put back after the test
    saved = [(mod, dict(vars(mod))) for mod in (ted, thash)]
    try:
        importlib.reload(ted)
        importlib.reload(thash)
        got = (ted.DEVICE_HASH_MAX_BLOCKS, thash.DEVICE_HASH_THRESHOLD)
        want = []
        for name, attr in (("crypto.ed25519", "DEVICE_HASH_MAX_BLOCKS"),
                           ("crypto.hash", "DEVICE_HASH_THRESHOLD")):
            full = f"cometbft_tpu.{name}_envcopy"
            spec = importlib.util.spec_from_file_location(
                full, path / (name.replace(".", "/") + ".py"))
            mod = importlib.util.module_from_spec(spec)
            monkeypatch.setitem(sys.modules, full, mod)
            spec.loader.exec_module(mod)
            want.append(getattr(mod, attr))
    finally:
        monkeypatch.undo()
        importlib.reload(ted)
        importlib.reload(thash)
        for mod, objects in saved:
            vars(mod).update(objects)
    assert got == tuple(want) == (5, 77)
    assert (ted.DEVICE_HASH_MAX_BLOCKS, thash.DEVICE_HASH_THRESHOLD) == \
        (3, 512)


# -- verdicts -----------------------------------------------------------------

def _verdicts(pks, msgs, sigs):
    return [tref.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]


def test_device_verify_hash_cpu_verdicts():
    """Accept; one tampered signature localized; a structural reject;
    each against ed25519_ref.verify."""
    pks, msgs, sigs = _signed(8, dup={6: 1})
    ok, out = tbatch._device_verify_hash(pks, msgs,
                                         ted.parse_batch(pks, sigs),
                                         device="cpu")
    assert ok and out == [True] * 8
    bad = list(sigs)
    bad[5] = bad[5][:3] + bytes([bad[5][3] ^ 0x10]) + bad[5][4:]
    bad[2] = bad[2][:32] + (L + 1).to_bytes(32, "little")
    for case in ([5], [2, 5]):
        sg = [bad[i] if i in case else sigs[i] for i in range(8)]
        ok, out = tbatch._device_verify_hash(pks, msgs,
                                             ted.parse_batch(pks, sg),
                                             device="cpu")
        assert not ok and out == _verdicts(pks, msgs, sg)
        assert [i for i, v in enumerate(out) if not v] == case


def test_device_verify_hash_oversized_and_single():
    pks, msgs, sigs = _signed(3)
    long = list(msgs)
    long[1] = b"z" * 400
    with pytest.raises(ValueError, match="message exceeds max_blocks"):
        tbatch._device_verify_hash(pks, long, ted.parse_batch(pks, sigs),
                                   device="cpu")
    with pytest.raises(ValueError, match="message exceeds max_blocks"):
        tbatch._device_verify_hash(pks[1:2], long[1:2],
                                   ted.parse_batch(pks[1:2], sigs[1:2]),
                                   device="cpu")
    # one signature skips the RLC program and runs the per-signature one
    ok, out = tbatch._device_verify_hash(pks[:1], msgs[:1],
                                         ted.parse_batch(pks[:1], sigs[:1]),
                                         device="cpu")
    assert ok and out == [True]


def test_split_rlc_verify_hash_over_a_device_list():
    """Two chunks on "cpu" twice: only the bad signature's chunk rejects;
    the split is off while the mesh is."""
    pks, msgs, sigs = _signed(6)
    bad = list(sigs)
    bad[4] = bad[4][:40] + bytes([bad[4][40] ^ 1]) + bad[4][41:]
    parsed = ted.parse_batch(pks, bad)
    assert tmesh.split_rlc_verify_hash(pks, msgs, parsed, [CPU, CPU]) == \
        [True, False]
    assert tmesh.maybe_split_verify_hash(pks, msgs, parsed, min_split=2) \
        is None
    bad[1] = b"\x00" * 63
    assert tmesh.split_rlc_verify_hash(
        pks, msgs, ted.parse_batch(pks, bad), [CPU, CPU]) is None


def test_split_rlc_verify_hash_copies_then_launches_then_reads(monkeypatch):
    """Every chunk's inputs reach its device before any program is
    launched, and every program is launched before any verdict is read:
    a copy from host memory waits for its device's queue."""
    pks, msgs, sigs = _signed(6)
    events = []

    class Verdict:
        def __init__(self, k):
            self.k = k

        def __bool__(self):
            events.append(("read", self.k))
            return True

    def copy(packed, device):
        events.append(("copy", len(events)))
        return (len(events) - 1,)

    def launch(k):
        events.append(("launch", k))
        return Verdict(k)

    monkeypatch.setattr(convert, "rlc_hash_from_numpy", copy)
    monkeypatch.setattr(tdev, "rlc_verify_hash_kernel", launch)
    assert tmesh.split_rlc_verify_hash(
        pks, msgs, ted.parse_batch(pks, sigs), [CPU, CPU, CPU]) == [True] * 3
    assert [e[0] for e in events] == ["copy"] * 3 + ["launch"] * 3 + \
        ["read"] * 3


def test_device_hash_program_copies_no_host_constant(monkeypatch):
    """Once a device has the programs' constants, neither device-hash
    program builds a tensor from host data: each would be a copy that
    makes the host wait for the card mid-program."""
    pks, msgs, sigs = _signed(5, dup={3: 1})
    parsed = ted.parse_batch(pks, sigs)
    rlc = convert.rlc_hash_from_numpy(
        ted.pack_rlc_device_hash(pks, msgs, sigs), CPU)
    a, r, s_l, bh, bl, nb, valid = ted.pack_batch_device_hash(
        pks, msgs, sigs, 16, parsed=parsed)
    one = convert.batch_hash_from_numpy(a, r, s_l, bh, bl, nb, CPU)
    want = (bool(tdev.rlc_verify_hash_kernel(*rlc)),
            tdev.verify_hash_kernel(*one).tolist())
    assert lb.const(sc.L_LIMBS, rlc[2]) is lb.const(sc.L_LIMBS, rlc[2])

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor built from host data mid-program")

    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    got = (bool(tdev.rlc_verify_hash_kernel(*rlc)),
           tdev.verify_hash_kernel(*one).tolist())
    monkeypatch.undo()
    assert got == want
    assert want[0] and want[1][:5] == [True] * 5


def test_entry_points_raise_without_a_card():
    pks, msgs, sigs = _signed(2)
    parsed = ted.parse_batch(pks, sigs)
    vals = tvs.ValidatorSet([tvs.Validator(ted.PubKey(p), 1) for p in pks])
    calls = [
        lambda: tbatch._device_verify_hash(pks, msgs, parsed),
        lambda: ted.rlc_verify_hash(ted.pack_rlc_device_hash(pks, msgs,
                                                             sigs)),
        lambda: thash.sum_sha256_many([b"a"] * 600),
        lambda: tmerkle.hash_from_byte_slices_device([b"a"] * 3),
        lambda: vals.hash(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# -- bulk SHA-256 and validator-set hashing -----------------------------------

def _validators(n):
    rng = random.Random(n)
    keys = [rng.randbytes(32) for _ in range(n)]
    powers = [rng.randrange(1, 1 << 40) for _ in range(n)]
    return (tvs.ValidatorSet([tvs.Validator(ted.PubKey(k), p)
                              for k, p in zip(keys, powers)]),
            jvs.ValidatorSet([jvs.Validator(jed.PubKey(k), p)
                              for k, p in zip(keys, powers)]))


@pytest.mark.parametrize("n", [4, 600])
def test_validator_set_hash_matches_jax(n):
    tv, jv = _validators(n)
    assert [v.bytes() for v in tv.validators] == \
        [v.bytes() for v in jv.validators]
    assert tv.hash(device="cpu") == jv.hash()


def test_merkle_and_bulk_sha256_match_jax(monkeypatch):
    rng = random.Random(10)
    items = [rng.randbytes(rng.choice((0, 1, 39, 40, 55, 56, 100)))
             for _ in range(600)]
    root = tmerkle.hash_from_byte_slices_device(items, device="cpu")
    assert root == jmerkle.hash_from_byte_slices_device(items) == \
        tmerkle.hash_from_byte_slices(items) == \
        jmerkle.hash_from_byte_slices(items)
    assert thash.sum_sha256_many(items, device="cpu") == \
        jhash.sum_sha256_many(items) == \
        [hashlib.sha256(x).digest() for x in items]
    for k in (0, 1, 2, 3, 5, 8, 600):
        assert tmerkle.split_point(k or 1) == jmerkle.split_point(k or 1)
    assert tmerkle.hash_from_byte_slices([]) == \
        jmerkle.hash_from_byte_slices([])
    # below the threshold nothing goes through the SHA-256 wrapper
    monkeypatch.setattr(sha2, "sha256_blocks",
                        lambda *a: pytest.fail("kernel route below 512"))
    assert thash.sum_sha256_many(items[:511], device="cpu") == \
        [hashlib.sha256(x).digest() for x in items[:511]]
    assert thash.sum_truncated(b"abc") == jhash.sum_truncated(b"abc")
    assert thash.sum_sha256(b"abc") == jhash.sum_sha256(b"abc")


# -- the whole programs against the JAX package (slow tier) -------------------

@pytest.mark.slow
def test_rlc_verify_hash_kernel_matches_jax(pinned_z):
    pks, msgs, sigs = _signed(8, dup={5: 2})
    bad = list(sigs)
    bad[3] = bad[3][:9] + bytes([bad[3][9] ^ 4]) + bad[3][10:]
    for sg, want in ((sigs, True), (bad, False)):
        packed = ted.pack_rlc_device_hash(pks, msgs, sg)
        got = bool(tdev.rlc_verify_hash_kernel(
            *convert.rlc_hash_from_numpy(packed, CPU)))
        jgot = bool(np.asarray(jdev.rlc_verify_hash_device(
            *jed.pack_rlc_device_hash(pks, msgs, sg))))
        assert got is jgot is want


@pytest.mark.slow
def test_verify_hash_kernel_matches_jax():
    pks, msgs, sigs = _signed(6)
    sigs[2] = sigs[2][:1] + bytes([sigs[2][1] ^ 2]) + sigs[2][2:]
    sigs[4] = b"\xff" * 64
    a, r, s, bh, bl, nb, valid = ted.pack_batch_device_hash(pks, msgs, sigs,
                                                            16)
    got = tdev.verify_hash_kernel(*convert.batch_hash_from_numpy(
        a, r, s, bh, bl, nb, CPU)).numpy() & valid
    ja = jed.pack_batch_device_hash(pks, msgs, sigs, 16)
    want = np.asarray(jdev.verify_batch_hash_device(*ja[:6])) & ja[6]
    np.testing.assert_array_equal(got, want)
    assert got[:6].tolist() == _verdicts(pks, msgs, sigs)
