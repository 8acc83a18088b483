"""The port's device modules (cometbft_tpu_torch/ops/ed25519.py,
cuda_decompress.py, cuda_msm.py) against the JAX package's XLA twins of
the Pallas kernels, on the CPU: the port's wrappers take their plain
versions for CPU tensors.  Decompression and tables agree limb for limb;
MSM sums agree projectively at frozen values; the fold, the identity
epilogue and the per-signature program agree on every verdict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import ed25519_ref as jref
from cometbft_tpu.ops import ed25519 as jdev
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import ed25519_ref as tref
from cometbft_tpu_torch.ops import cuda_decompress, cuda_msm
from cometbft_tpu_torch.ops import ed25519 as tdev
from cometbft_tpu_torch.ops import fe as tfe
from cometbft_tpu_torch import convert

W = 16
P = tfe.P


def _affine_points(n, distinct=8, salt=0):
    """n points (x, y) as Python ints: multiples of B, tiled."""
    out = []
    for i in range(distinct):
        x, y, z, _ = tref.point_mul(7919 * (i + 1) + 3 + salt, tref.B)
        zi = pow(z, P - 2, P)
        out.append((x * zi % P, y * zi % P))
    return [out[i % distinct] for i in range(n)]


def _limbs(pts):
    """[(x, y)] -> (4, 20, n) int32 extended points, Z = 1."""
    cols = [(x, y, 1, x * y % P) for x, y in pts]
    return np.stack([np.stack([tfe.int_to_limbs(c[k]) for c in cols], 1)
                     for k in range(4)]).astype(np.int32)


def _proj(pt):
    """(4, 20, n) limbs -> per lane (x, y) affine Python ints."""
    pt = np.asarray(pt)
    out = []
    for i in range(pt.shape[-1]):
        x, y, z = (tfe.limbs_to_int(pt[c, :, i]) for c in range(3))
        zi = pow(z, P - 2, P)
        out.append((x * zi % P, y * zi % P))
    return out


def _hostile_encodings():
    """Valid points plus every decompression edge: non-canonical y
    (y = p + 3 on the curve, y = p + 1 the identity), the identity with
    the sign bit set (x = 0, sign 1: reject), an 8-torsion point, and
    y values whose u/v is not a square (reject)."""
    encs = [tref.point_compress(tref.point_mul(6151 * i + 11, tref.B))
            for i in range(W - 7)]
    encs.append((P + 3).to_bytes(32, "little"))
    encs.append((P + 1).to_bytes(32, "little"))
    encs.append((1 | (1 << 255)).to_bytes(32, "little"))
    encs.append(bytes.fromhex(
        "26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05"))
    bad = [y for y in range(2, 64)
           if tref.point_decompress(y.to_bytes(32, "little")) is None]
    encs += [y.to_bytes(32, "little") for y in bad[:2]]
    encs.append(b"\x13" * 31 + b"\x80")
    assert len(encs) == W
    return encs


def _words(encs):
    return np.stack([np.frombuffer(e, dtype=np.uint32) for e in encs], 1)


def test_decompress_matches_xla_twin():
    encs = _hostile_encodings()
    words = _words(encs)
    want_pt, want_ok = jax.jit(jdev.decompress)(jnp.asarray(words))
    got_pt, got_ok = tdev.decompress(convert.words_from_numpy(words, "cpu"))
    assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert np.array_equal(got_pt.numpy(), np.asarray(want_pt))
    oracle = [tref.point_decompress(e) is not None for e in encs]
    assert got_ok.numpy().tolist() == oracle
    assert not all(oracle) and any(oracle)
    assert cuda_decompress.decompress.launches == 0     # CPU: plain only


def test_table17_neg_matches_xla_twin():
    pts = _limbs(_affine_points(W))
    want = np.array(jdev._table17(jdev.point_neg(jnp.asarray(pts))))
    got = cuda_msm.table17_neg(torch.from_numpy(pts)).numpy()
    assert got.shape == (17, 4, 20, W)
    assert np.array_equal(got, want)
    # row k is k * (-P)
    x, y = _affine_points(1)[0]
    for k in (0, 1, 5, 16):
        want_k = tref.point_mul(k, tref.point_neg((x, y, 1, x * y % P)))
        zi = pow(want_k[2], P - 2, P)
        assert _proj(got[k])[0] == (want_k[0] * zi % P, want_k[1] * zi % P)


def _msm_inputs(w, nwin, seed):
    rng = np.random.default_rng(seed)
    pts = _affine_points(w, salt=seed)
    tab = cuda_msm.table17_neg(torch.from_numpy(_limbs(pts)))
    mags = rng.integers(0, 17, (nwin, w), dtype=np.int32)
    negs = rng.integers(0, 2, (nwin, w)) != 0
    return pts, tab, mags, negs


def test_msm_matches_msm_scan():
    """K3's plain version (one partial per lane chunk: window sums, then
    one Horner chain per chunk, in the kernel's order) sums to the JAX
    shared-doubling scan."""
    _, tab, mags, negs = _msm_inputs(W, 4, 13)
    want = jdev._msm_scan(jnp.asarray(tab.numpy()), jnp.asarray(mags),
                          jnp.asarray(negs))
    parts = cuda_msm.msm_window_major(tab, torch.from_numpy(mags),
                                      torch.from_numpy(negs))
    assert parts.shape == (4, 20, 1)
    assert _proj(parts.numpy()) == _proj(np.array(want))
    got = tdev._msm_scan(tab, torch.from_numpy(mags), torch.from_numpy(negs))
    assert _proj(got.numpy()) == _proj(np.array(want))


def test_msm_magnitudes_out_of_range_match_msm_scan():
    """Magnitudes 17, 31 and -1 select row 0, the identity, in K3's
    plain version as in the JAX select cascade (_select17 in the XLA
    scan): the partials sum to the JAX scan's point."""
    _, tab, mags, negs = _msm_inputs(W, 4, 23)
    mags[0, :3] = (17, 31, -1)
    mags[2, 5:8] = (-1, 17, 31)
    negs[2, 5:8] = True
    want = jdev._msm_scan(jnp.asarray(tab.numpy()), jnp.asarray(mags),
                          jnp.asarray(negs))
    parts = cuda_msm.msm_window_major_plain(tab, torch.from_numpy(mags),
                                            torch.from_numpy(negs))
    assert _proj(tdev._tree_reduce(parts, 1).numpy()) == _proj(np.array(want))
    zeroed = mags.copy()
    zeroed[0, :3] = 0
    zeroed[2, 5:8] = 0
    assert torch.equal(parts, cuda_msm.msm_window_major_plain(
        tab, torch.from_numpy(zeroed), torch.from_numpy(negs)))


def test_msm_multiblock_ragged_matches_scalar_sum():
    """Two K3 lane chunks, the second ragged (40 lanes): the partials' sum
    is sum_i e_i * (-P_i) with e_i the signed digits read MSB-first."""
    w, nwin = 40, 3
    pts, tab, mags, negs = _msm_inputs(w, nwin, 7)
    parts = cuda_msm.msm_window_major(tab, torch.from_numpy(mags),
                                      torch.from_numpy(negs))
    assert parts.shape == (4, 20, 2)
    want = tref.IDENT
    for i, (x, y) in enumerate(pts):
        e = 0
        for j in range(nwin):
            e = 32 * e + (-1 if negs[j, i] else 1) * int(mags[j, i])
        p = tref.point_neg((x, y, 1, x * y % P))
        if e < 0:
            e, p = -e, tref.point_neg(p)
        want = tref.point_add(want, tref.point_mul(e, p))
    zi = pow(want[2], P - 2, P)
    got = tdev._tree_reduce(parts, 1)
    assert _proj(got.numpy()) == [(want[0] * zi % P, want[1] * zi % P)]


def _xla_epilogue_verdict(pa, pr):
    total = jdev.point_add(jdev._tree_reduce(jnp.asarray(pa), 1),
                           jdev._tree_reduce(jnp.asarray(pr), 1))
    for _ in range(3):
        total = jdev.point_double(total, with_t=False)
    return bool(jdev.point_is_identity(total)[0])


def test_fold_verify_matches_xla_epilogue():
    """Accept (R side = -A side), accept with an 8-torsion component
    (the cofactor clears it), reject (R side = A side), at widths that
    are not multiples of anything."""
    pa = _limbs(_affine_points(5, distinct=5))
    neg_pa = tdev.point_neg(torch.from_numpy(pa)).numpy()
    t8 = jref.point_decompress(bytes.fromhex(
        "26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05"))
    pr_t = np.concatenate([neg_pa, _limbs([(t8[0], t8[1])])], axis=-1)
    for a, r, want in ((pa, neg_pa, True), (pa, pr_t, True),
                       (pa, pa, False)):
        assert _xla_epilogue_verdict(a, r) is want
        got = cuda_msm.fold_verify(torch.from_numpy(a), torch.from_numpy(r))
        assert got.dim() == 0 and bool(got) is want


def _signed_batch(n, seed):
    rng = np.random.default_rng(seed)
    pks, msgs, sigs = [], [], []
    for i in range(n):
        k = ted.PrivKey.generate(rng.bytes(32))
        m = rng.bytes(40 + i)
        pks.append(k.pub_key().bytes())
        msgs.append(m)
        sigs.append(k.sign(m))
    return pks, msgs, sigs


def _hostile_batch():
    """Valid, tampered, wrong-message, s >= L, a non-canonical-y key
    (y = p + 3, junk signature), and a VALID signature under the
    non-canonical encoding of the identity (R = sB makes the cofactored
    equation hold for any message)."""
    pks, msgs, sigs = _signed_batch(6, seed=21)
    sigs[1] = sigs[1][:10] + bytes([sigs[1][10] ^ 0xFF]) + sigs[1][11:]
    msgs[2] = msgs[2] + b"!"
    sigs[3] = sigs[3][:32] + (tref.L + 5).to_bytes(32, "little")
    pks.append((P + 3).to_bytes(32, "little"))
    msgs.append(b"noncanonical")
    sigs.append(sigs[0])
    s = 123456789
    pks.append((P + 1).to_bytes(32, "little"))
    msgs.append(b"identity key")
    sigs.append(tref.point_compress(tref.point_mul(s, tref.B))
                + s.to_bytes(32, "little"))
    return pks, msgs, sigs


def test_verify_kernel_verdicts_bucket16():
    """The per-signature program at bucket 16 against the JAX package's
    ZIP-215 oracle (its host verifier), entry by entry; the slow tier
    holds it against the JAX per-signature program itself."""
    pks, msgs, sigs = _hostile_batch()
    want = [jref.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    assert want == [True, False, False, False, True, True, False, True]
    bucket = tdev.bucket_size(len(pks))
    assert bucket == 16
    a, r, s, h, valid = ted.pack_batch(pks, msgs, sigs, bucket)
    got = tdev.verify_kernel(*convert.batch_from_numpy(a, r, s, h, "cpu"))
    got = (got.numpy() & valid)[:len(pks)].tolist()
    assert got == want


@pytest.mark.slow
def test_verify_kernel_matches_jax_program():
    pks, msgs, sigs = _hostile_batch()
    a, r, s, h, valid = ted.pack_batch(pks, msgs, sigs, 16)
    want = np.asarray(jdev.verify_batch_device(a, r, s, h))
    got = tdev.verify_kernel(*convert.batch_from_numpy(a, r, s, h, "cpu"))
    assert np.array_equal(got.numpy() & valid, want & valid)


@pytest.mark.slow
def test_rlc_program_matches_jax_program():
    """The whole RLC program (52 A windows, 26 R windows) against the
    JAX package's rlc_verify_kernel on the same packed batch: accept,
    then reject after tampering one signature.  XLA-CPU compiles the
    JAX program in minutes, hence the slow tier."""
    pks, msgs, sigs = _signed_batch(8, seed=31)
    fn = jax.jit(jdev.rlc_verify_kernel)
    for tamper in (False, True):
        if tamper:
            sigs[5] = sigs[5][:3] + bytes([sigs[5][3] ^ 4]) + sigs[5][4:]
        packed = ted.pack_rlc(pks, msgs, sigs)
        want = bool(np.asarray(fn(*packed)))
        got = bool(tdev.rlc_verify_kernel(
            *convert.packed_from_numpy(packed, "cpu")))
        assert got is want is (not tamper)
