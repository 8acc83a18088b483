"""K3, the port's window-major Straus MSM (cometbft_tpu_torch/ops/cuda_msm.py
msm_window_major: window sums per lane chunk, then one Horner chain per
chunk), against the JAX package on the CPU, where the wrapper runs its
plain version.

Tolerance: exact.  The partials (4, 20, k) are reduced with the port's
_tree_reduce and compared at canonical values — affine (x, y) as Python
ints — with the JAX XLA scan (_msm_scan), with the interpret-mode Pallas
kernel, and with sum_i e_i * (-P_i) computed with ed25519_ref.  Digits
17, 31 and -1 select the identity, as the JAX select cascade does.

The XLA scan is one jitted program at one shape, traced and compiled
once for its six cases: each case's digits sit in the last windows and
first lanes of (SCAN_NWIN, SCAN_W), the rest zero digits, which select
the identity."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import ed25519 as jdev
from cometbft_tpu.ops import pallas_msm as pm
from cometbft_tpu_torch.crypto import ed25519_ref as tref
from cometbft_tpu_torch.ops import cuda_msm
from cometbft_tpu_torch.ops import ed25519 as tdev
from cometbft_tpu_torch.ops import fe as tfe

P = tfe.P
WIDTHS = (1, 31, 33, 40, 128, 200)
NWINS = (1, 3, 26)
SCAN_CASES = [(1, 26), (31, 3), (33, 1), (40, 26), (128, 3), (200, 1)]
SCAN_W, SCAN_NWIN = 200, 26


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain version runs thousands of small torch ops; beside other
    busy test workers, OpenMP's threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(n, seed):
    """n affine points (x, y): multiples of B by seeded scalars, 8 of
    them tiled."""
    rng = np.random.default_rng(seed)
    out = []
    for s in rng.integers(1, 1 << 62, 8):
        x, y, z, _ = tref.point_mul(int(s), tref.B)
        zi = pow(z, P - 2, P)
        out.append((x * zi % P, y * zi % P))
    return [out[i % 8] for i in range(n)]


def _limbs(pts):
    cols = [(x, y, 1, x * y % P) for x, y in pts]
    return np.stack([np.stack([tfe.int_to_limbs(c[k]) for c in cols], 1)
                     for k in range(4)]).astype(np.int32)


def _affine(pt):
    """(4, 20, n) limbs -> per lane (x, y) affine Python ints."""
    pt = np.asarray(pt)
    out = []
    for i in range(pt.shape[-1]):
        x, y, z = (tfe.limbs_to_int(pt[c, :, i]) for c in range(3))
        zi = pow(z, P - 2, P)
        out.append((x * zi % P, y * zi % P))
    return out


def _inputs(w, nwin, seed):
    """Points, their negated tables (the port's plain K2, limb-equal to
    the JAX package's) and signed digits from a numpy seed, with
    magnitudes 17, 31 and -1 in the first and last windows."""
    rng = np.random.default_rng(seed)
    pts = _points(w, seed)
    tab = cuda_msm.table17_neg(torch.from_numpy(_limbs(pts)))
    mags = rng.integers(0, 17, (nwin, w)).astype(np.int32)
    negs = rng.integers(0, 2, (nwin, w)) != 0
    for j, i in ((0, 0), (nwin - 1, w - 1)):
        for d in (17, 31, -1):
            mags[j, i] = d
            i = (i + 5) % w
    return pts, tab, mags, negs


def _embed(tab, mags, negs):
    """A case's table and digits inside the scan's one shape: its digits
    in the last windows (MSB-first, so the leading windows only double
    the identity) and first lanes; lane 0's table fills the rest, under
    digit 0."""
    nwin, w = mags.shape
    t = tab.numpy()
    big = np.concatenate([t, np.repeat(t[..., :1], SCAN_W - w, -1)], -1)
    m = np.zeros((SCAN_NWIN, SCAN_W), np.int32)
    n = np.zeros((SCAN_NWIN, SCAN_W), bool)
    m[SCAN_NWIN - nwin:, :w] = mags
    n[SCAN_NWIN - nwin:, :w] = negs
    return big, m, n


@pytest.fixture(scope="module")
def scan_case():
    """The JAX package's XLA scan of every SCAN_CASES input, jitted
    once, and the inputs."""
    scan = jax.jit(jdev._msm_scan)
    inputs = {c: _inputs(c[0], c[1], 7 * c[0] + c[1]) for c in SCAN_CASES}
    return inputs, {c: np.asarray(scan(*(jnp.asarray(x)
                                         for x in _embed(*v[1:]))))
                    for c, v in inputs.items()}


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


def _k3_sum(tab, mags, negs):
    parts = cuda_msm.msm_window_major(tab, torch.from_numpy(mags),
                                      torch.from_numpy(negs), group=1)
    _, _, k = cuda_msm.msm_geometry(mags.shape[1], mags.shape[0])
    assert parts.shape == (4, 20, k)
    return _affine(tdev._tree_reduce(parts, 1))


def _scalar_sum(pts, mags, negs):
    """sum_i e_i * (-P_i), e_i the signed digits read MSB-first (a
    magnitude outside 0..16 counts 0), with ed25519_ref."""
    acc = tref.IDENT
    for i, (x, y) in enumerate(pts):
        e = 0
        for j in range(mags.shape[0]):
            m = int(mags[j, i])
            e = 32 * e + (0 if not 0 <= m <= 16 else -m if negs[j, i] else m)
        p = tref.point_neg((x, y, 1, x * y % P))
        if e < 0:
            e, p = -e, tref.point_neg(p)
        acc = tref.point_add(acc, tref.point_mul(e, p))
    zi = pow(acc[2], P - 2, P)
    return [(acc[0] * zi % P, acc[1] * zi % P)]


@pytest.mark.parametrize("nwin", NWINS)
@pytest.mark.parametrize("w", WIDTHS)
def test_k3_equals_scalar_sum(w, nwin):
    """Every width and window count: the partials' sum is the MSM."""
    pts, tab, mags, negs = _inputs(w, nwin, 1000 * w + nwin)
    assert _k3_sum(tab, mags, negs) == _scalar_sum(pts, mags, negs)
    assert cuda_msm.msm_window_major.launches == 0     # CPU: plain only


@pytest.mark.parametrize("w, nwin", SCAN_CASES)
def test_k3_matches_xla_msm_scan(scan_case, w, nwin):
    """Each width and window count once against the JAX package's XLA
    scan (one jitted program, each case embedded in its shape)."""
    inputs, want = scan_case
    _, tab, mags, negs = inputs[(w, nwin)]
    assert _k3_sum(tab, mags, negs) == _affine(want[(w, nwin)])


def test_k3_matches_pallas_kernel():
    """The interpret-mode Pallas kernel (one block of 8 lanes, two
    windows: the doubling chain runs once) gives the same point."""
    _, tab, mags, negs = _inputs(8, 2, 88)
    want = pm.msm_window_major(jnp.asarray(tab.numpy()), jnp.asarray(mags),
                               jnp.asarray(negs), interpret=True, blk=8,
                               group=1)
    assert _k3_sum(tab, mags, negs) == \
        _affine(jdev._tree_reduce(jnp.asarray(want), 1))


@pytest.mark.parametrize("min_blocks, geometry", [
    (1, (32, 1024, 1)), (4, (8, 256, 2)), (8, (4, 128, 3)),
    (12, (2, 64, 6))])
def test_k3_holder_rows(monkeypatch, min_blocks, geometry):
    """Fewer window-sum blocks asked for: holders sum several lanes
    each (2.25 product rounds per add on the card), ragged last chunks,
    the same MSM — at a ragged width, 3 windows."""
    monkeypatch.setattr(cuda_msm, "MSM_MIN_BLOCKS", min_blocks)
    w, nwin = 333, 3
    assert cuda_msm.msm_geometry(w, nwin) == geometry
    pts, tab, mags, negs = _inputs(w, nwin, 5)
    assert _k3_sum(tab, mags, negs) == _scalar_sum(pts, mags, negs)


def test_k3_is_window_sums_then_horner():
    """The partials are the window sums run through the Straus step per
    chunk, limb for limb, and each window's chunk sums add up to that
    window's digits times the points."""
    pts, tab, mags, negs = _inputs(70, 3, 9)
    m, n = torch.from_numpy(mags), torch.from_numpy(negs)
    sums = cuda_msm.msm_window_sums_plain(tab, m, n)
    assert sums.shape == (4, 20, 3, 3)
    acc = sums[:, :, 0]
    for j in (1, 2):
        acc = tdev.straus_step(acc, sums[:, :, j])
    assert torch.equal(acc, cuda_msm.msm_window_major(tab, m, n, group=1))
    for j in range(3):
        assert _affine(tdev._tree_reduce(sums[:, :, j], 1)) == \
            _scalar_sum(pts, mags[j:j + 1], negs[j:j + 1])


def test_k3_out_of_range_digits_are_zero():
    """Magnitudes 17, 31 and -1 give the same partials, limb for limb,
    as digit 0 in their place."""
    _, tab, mags, negs = _inputs(40, 3, 11)
    zeroed = mags.copy()
    zeroed[(mags < 0) | (mags > 16)] = 0
    assert (zeroed != mags).sum() == 6
    got, want = (cuda_msm.msm_window_major(tab, torch.from_numpy(m),
                                           torch.from_numpy(negs), group=1)
                 for m in (mags, zeroed))
    assert torch.equal(got, want)


@pytest.mark.parametrize("nwin, w, geometry", [
    (52, 128, (1, 32, 4)), (26, 128, (1, 32, 4)), (26, 5120, (16, 512, 10)),
    (52, 10240, (32, 1024, 10)), (26, 8192, (32, 1024, 8)),
    (52, 32, (1, 32, 1))])
def test_k3_geometry_at_main_path_shapes(nwin, w, geometry):
    """The commit (128 lanes each side), the window's R side (5120), the
    batch (10240 A, 8192 R) and the chain-only case: every shape gives
    the 132 SMs of an H100 at least 3 warps of window sums each, and k
    partials no more than the 32-lane blocks K4 folded before."""
    rows, chunk, k = cuda_msm.msm_geometry(w, nwin)
    assert (rows, chunk, k) == geometry
    assert chunk == cuda_msm.MSM_HOLDERS * rows and (k - 1) * chunk < w
    if w >= 128:
        assert nwin * k * cuda_msm.MSM_WARPS >= 3 * 132
    assert k <= -(-w // 32)
