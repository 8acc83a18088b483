"""K5, the port's grouped window-major MSM (cometbft_tpu_torch/ops/
cuda_msm.py msm_window_major_grouped), on the CPU, where the wrapper runs
its plain version msm_window_major_grouped_plain.

The CUDA kernel (ops/csrc/ed25519_engines.cu) runs in two launches: the
window sums, four thread quads per (window, 32-lane block), then K3's
Horner kernel per block.  Here the window sums' schedule is modelled in
torch, add for add and operand for operand: quad h sums its leaves
(lane t plus lane t + 16, t = h, h + 8, h + 4, h + 12) as add_cached of
to_cached(right), then leaf 0 + leaf 1, leaf 2 + leaf 3, and those two;
then quads h < 2 add quad h + 2, and quad 0 adds quad 1.  The model is
held against the plain version's own order (each block's _block_tree,
lane t adding lane t + s), and "window sums, then straus_step in MSB
order" against msm_window_major_grouped_plain.  The kernel itself runs
only on the card; its wrapper's kernel route is checked here up to its
argument checks, which raise before anything is built.

Tolerance: exact — torch.equal on the int32 limbs (no freezing): the
kernel and the plain version are the same additions on the same
operands."""

import gc

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import ed25519_ref as tref
from cometbft_tpu_torch.ops import cuda_msm
from cometbft_tpu_torch.ops import ed25519 as tdev
from cometbft_tpu_torch.ops import fe as tfe

P = tfe.P
WIDTHS = (1, 31, 33, 200)
NWINS = (1, 3, 26)


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


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain version runs thousands of small torch ops; beside other
    busy test workers, OpenMP's threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _limbs(pts):
    """[(X, Y, Z, T)] Python ints -> (4, 20, n) int32."""
    return np.stack([np.stack([tfe.int_to_limbs(p[c]) for p in pts], 1)
                     for c in range(4)]).astype(np.int32)


def _inputs(w, nwin, seed):
    """Negated tables of w seeded points (the port's plain K2) and signed
    digits from a numpy seed, with magnitudes 17, 31 and -1 (they select
    the identity) in the first and last windows."""
    rng = np.random.default_rng(seed)
    pool = [tref.point_mul(int(k), tref.B)
            for k in rng.integers(1, 1 << 62, 8)]
    tab = cuda_msm.table17_neg(torch.from_numpy(
        _limbs([pool[i % 8] for i in range(w)])))
    mags = rng.integers(0, 17, (nwin, w)).astype(np.int32)
    negs = rng.integers(0, 2, (nwin, w)) != 0
    for j in {0, nwin - 1}:
        for i, d in zip(rng.integers(0, w, 3), (17, 31, -1)):
            mags[j, i] = d
    return tab, torch.from_numpy(mags), torch.from_numpy(negs)


# leaf i of quad h is lane h + LEAF_LANES[i] plus the lane 16 past it
LEAF_LANES = (0, 8, 4, 12)


def _quad_sums(pts):
    """(4, 20, nblk, 32) selected rows -> (4, 20, nblk): the kernel's
    window-sum schedule, every block at once."""
    t4 = []
    for h in range(cuda_msm.GROUP_QUADS):
        leaf = [tdev.add_cached(pts[..., h + d],
                                tdev.to_cached(pts[..., h + d + 16]))
                for d in LEAF_LANES]
        t4.append(tdev.point_add(tdev.point_add(leaf[0], leaf[1]),
                                 tdev.point_add(leaf[2], leaf[3])))
    t2 = [tdev.point_add(t4[h], t4[h + 2]) for h in range(2)]
    return tdev.point_add(t2[0], t2[1])


def _model_sums(tab, mags, negs):
    """(4, 20, nwin, nblk): the kernel's window sums."""
    nwin, w = mags.shape
    nblk = -(-w // cuda_msm.GROUP_LANES)
    return torch.stack([_quad_sums(cuda_msm._select_signed(
        tab, mags[j], negs[j], nblk * 32).reshape(4, 20, nblk, 32))
        for j in range(nwin)], dim=2)


def test_leaves_cover_the_block_once():
    lanes = [h + d + r for h in range(cuda_msm.GROUP_QUADS)
             for d in LEAF_LANES for r in (0, 16)]
    assert sorted(lanes) == list(range(cuda_msm.GROUP_LANES))


@pytest.mark.parametrize("nwin", NWINS)
@pytest.mark.parametrize("w", WIDTHS)
def test_quad_schedule_equals_block_tree(w, nwin):
    """The quads' schedule equals the plain version's per-block pairwise
    tree limb for limb, lanes past W the identity."""
    tab, mags, negs = _inputs(w, nwin, 11 + w + nwin)
    nblk = -(-w // 32)
    for j in range(nwin):
        pts = cuda_msm._select_signed(tab, mags[j], negs[j], nblk * 32)
        pts = pts.reshape(4, 20, nblk, 32)
        assert torch.equal(_quad_sums(pts), cuda_msm._block_tree(pts))


@pytest.mark.parametrize("w, nwin, group", [(40, 6, 2), (40, 6, 3),
                                            (33, 26, 13), (200, 3, 3)])
def test_k5_is_window_sums_then_straus(w, nwin, group):
    """The kernel's two launches — window sums, then per block
    acc <- straus_step(acc, S[j]) in MSB order — give
    msm_window_major_grouped_plain's partials limb for limb, whatever
    the group."""
    tab, mags, negs = _inputs(w, nwin, 3 * w + nwin)
    sums = _model_sums(tab, mags, negs)
    acc = sums[:, :, 0]
    for j in range(1, nwin):
        acc = tdev.straus_step(acc, sums[:, :, j])
    want = cuda_msm.msm_window_major_grouped_plain(tab, mags, negs, group)
    assert want.shape == (4, 20, -(-w // 32))
    assert torch.equal(acc, want)
    cuda_msm.msm_window_major_grouped.launches = 0
    assert torch.equal(cuda_msm.msm_window_major_grouped(
        tab, mags, negs, group), want)
    assert cuda_msm.msm_window_major_grouped.launches == 0   # CPU: plain


def test_k5_sum_is_the_scalar_sum():
    """The partials' lane sum is sum_i e_i * (-P_i) (ed25519_ref), e_i
    the signed digits MSB-first, a magnitude outside 0..16 counting 0."""
    w, nwin = 40, 3
    rng = np.random.default_rng(7)
    ks = [int(k) for k in rng.integers(1, 1 << 62, w)]
    pts = [tref.point_mul(k, tref.B) for k in ks]
    tab = cuda_msm.table17_neg(torch.from_numpy(_limbs(pts)))
    mags = rng.integers(0, 17, (nwin, w)).astype(np.int32)
    negs = rng.integers(0, 2, (nwin, w)) != 0
    mags[1, 4] = 31
    got = cuda_msm.msm_window_major_grouped(
        tab, torch.from_numpy(mags), torch.from_numpy(negs), 3)
    total = tdev._tree_reduce(got, 1)
    want = tref.IDENT
    for i, p in enumerate(pts):
        e = 0
        for j in range(nwin):
            m = int(mags[j, i])
            e = 32 * e + (0 if not 0 <= m <= 16 else -m if negs[j, i] else m)
        want = tref.point_add(want, tref.point_mul(e % tref.L,
                                                   tref.point_neg(p)))
    x, y, z = (tfe.limbs_to_int(total[c, :, 0].numpy()) for c in range(3))
    assert (x * want[2] - want[0] * z) % P == 0
    assert (y * want[2] - want[1] * z) % P == 0


@pytest.mark.parametrize("group", [0, -2, 4, 5])
def test_k5_group_must_divide_windows(group):
    tab, mags, negs = _inputs(8, 6, 1)
    with pytest.raises(ValueError, match="does not divide"):
        cuda_msm.msm_window_major_grouped(tab, mags, negs, group)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, so the wrapper
    takes its kernel route; the checks below raise before anything is
    built or launched."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("tab, mags, negs, err", [
    ((17, 4, 20, 8), ((6, 8), torch.int32), ((6, 8), torch.int32),
     TypeError),
    ((17, 4, 20, 8), ((6, 7), torch.int32), ((6, 8), torch.bool),
     ValueError),
    ((16, 4, 20, 8), ((6, 8), torch.int32), ((6, 8), torch.bool),
     ValueError),
], ids=["k5-sign-dtype", "k5-width", "k5-rows"])
def test_grouped_kernel_route_rejects_wrong_dtype_or_shape(tab, mags, negs,
                                                           err):
    cuda_msm.msm_window_major_grouped.launches = 0
    with pytest.raises(err, match="expected"):
        cuda_msm.msm_window_major_grouped(
            torch.zeros(tab, dtype=torch.int32).as_subclass(_OnCard),
            torch.zeros(mags[0], dtype=mags[1]),
            torch.zeros(negs[0], dtype=negs[1]), 3)
    assert cuda_msm.msm_window_major_grouped.launches == 0
