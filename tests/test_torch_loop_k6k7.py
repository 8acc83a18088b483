"""K6 and K7, the port's window-loop and select-tree MSM kernels
(cometbft_tpu_torch/ops/cuda_msm.py msm_window_loop / select_tree), on
the CPU, where the wrappers run their plain versions, at blocks of any
power-of-two row count r = blk / out_l, as the JAX package takes them.

The CUDA kernels (ops/csrc/ed25519_engines.cu) share one window-sum
kernel: task (window j, output lane g) sums the lane's r selected rows
on qt = 1, 2, 4 or 8 thread quads; quad h holds rows h + qt t, reduces
them depth first (leaf i = row p + row p + m/2 at position p =
bitrev(i), then for each trailing one bit l of i, v = pending[l] + v),
and the quads are reduced across by shuffles (quad h adds quad h + s for
s = qt/2 .. 1).  K7 stores one window's sums; K6 runs K3's Horner chain
over every window's.  Here that schedule is modelled in torch, add for
add and operand for operand, from the kernel's own lane arithmetic, and
held against the plain version's order (_block_contrib: lane L adds lane
L + half) for every qt up to r, a superset of the launcher's choices (at
most r / 2 quads, or one at r = 1).

The partials at 16 and 32 rows per output lane (OUT_PER_BLK lowered, as
test_torch_msm_engines.py lowers it) are held lane by lane against the
JAX package: each output lane's value is the sum, over the lanes the
Pallas layout gives it, of e_i * (-P_i) computed with the JAX package's
ed25519_ref, e_i the lane's signed digits MSB-first (the Pallas
kernels' interpret mode takes minutes at these block sizes here).

Tolerance: exact.  The schedule model and the K6 recurrence are held
limb for limb (torch.equal on the int32 limbs: the same additions on the
same operands); the JAX package's values at canonical values (affine
coordinates, projective equality)."""

import gc

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import ed25519_ref as jref
from cometbft_tpu_torch.ops import cuda_msm
from cometbft_tpu_torch.ops import ed25519 as tdev
from cometbft_tpu_torch.ops import fe as tfe

P = tfe.P
QUADS = (1, 2, 4, 8)       # quads per task the kernel takes, up to r


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
    """The plain versions run thousands of small torch ops; beside other
    busy test workers, OpenMP's threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _block_defaults(monkeypatch):
    monkeypatch.setattr(cuda_msm, "BLK", 512)
    monkeypatch.setattr(cuda_msm, "OUT_PER_BLK", 128)


def _limbs(pts):
    """[(X, Y, Z, T)] Python ints -> (4, 20, n) int32."""
    return np.stack([np.stack([tfe.int_to_limbs(p[c]) for p in pts], 1)
                     for c in range(4)]).astype(np.int32)


def _inputs(w, nwin, seed):
    """Negated tables of w points (eight seeded multiples of B from the
    JAX package's ed25519_ref, tiled), built by the port's plain K2, and
    signed digits from a numpy seed, with magnitudes 17, 31 and -1 (they
    select the identity) in the first and last windows.  Returns the
    points too."""
    rng = np.random.default_rng(seed)
    pool = [jref.point_mul(int(k), jref.B)
            for k in rng.integers(1, 1 << 62, 8)]
    pts = [pool[i % 8] for i in range(w)]
    tab = cuda_msm.table17_neg(torch.from_numpy(_limbs(pts)))
    mags = rng.integers(0, 17, (nwin, w)).astype(np.int32)
    negs = rng.integers(0, 2, (nwin, w)) != 0
    for j in {0, nwin - 1}:
        for i, d in zip(rng.integers(0, w, 3), (17, 31, -1)):
            mags[j, i] = d
    return tab, torch.from_numpy(mags), torch.from_numpy(negs), pts


def _affine(pt):
    """(4, 20, n) limbs -> per lane (x, y) affine Python ints."""
    pt = np.asarray(pt)
    out = []
    for i in range(pt.shape[-1]):
        x, y, z = (tfe.limbs_to_int(pt[c, :, i]) for c in range(3))
        zi = pow(z, P - 2, P)
        out.append((x * zi % P, y * zi % P))
    return out


def _jax_partials(pts, mags, negs, blk, out_l):
    """Per output lane g = i * out_l + o of the Pallas layout: the sum of
    e * (-P) over lanes i * blk + o + k * out_l < w (JAX package's
    ed25519_ref), e the lane's digits MSB-first, a magnitude outside
    0..16 counting 0.  Affine (x, y) per lane."""
    nwin, w = mags.shape
    nblk = -(-w // blk)
    out = []
    for g in range(nblk * out_l):
        coef = {}                   # point -> sum of its lanes' e
        for k in range(blk // out_l):
            lane = g // out_l * blk + g % out_l + k * out_l
            if lane >= w:
                continue
            e = 0
            for j in range(nwin):
                m = int(mags[j, lane])
                d = m if 0 <= m <= 16 else 0
                e = 32 * e + (-d if negs[j, lane] else d)
            coef[pts[lane]] = coef.get(pts[lane], 0) + e
        acc = jref.IDENT
        for pt, e in coef.items():
            acc = jref.point_add(acc, jref.point_mul(e % jref.L,
                                                     jref.point_neg(pt)))
        zi = pow(acc[2], P - 2, P)
        out.append((acc[0] * zi % P, acc[1] * zi % P))
    return out


# -- (a) the repaired row cap, against the JAX package -------------------------

@pytest.mark.parametrize("rows", [16, 32])
def test_wide_blocks_match_jax_package_per_lane(monkeypatch, rows):
    """16 and 32 rows per output lane (two output lanes per block, two
    blocks, three windows), blocks the JAX package takes: K6's per-block
    accumulators and K7's window partials equal its values output lane
    by output lane."""
    out_l, nwin = 2, 3
    blk = rows * out_l
    monkeypatch.setattr(cuda_msm, "OUT_PER_BLK", out_l)
    tab, mags, negs, pts = _inputs(2 * blk, nwin, 40 + rows)
    got = cuda_msm.msm_window_loop(tab, mags, negs, blk)
    assert got.shape == (4, 20, 2 * out_l)
    assert _affine(got) == _jax_partials(pts, mags, negs, blk, out_l)
    for j in (0, nwin - 1):
        part = cuda_msm.select_tree(tab, mags[j], negs[j], blk)
        assert _affine(part) == _jax_partials(pts, mags[j:j + 1],
                                              negs[j:j + 1], blk, out_l)
    assert cuda_msm.msm_window_loop.launches == 0       # CPU: plain only
    assert cuda_msm.select_tree.launches == 0


@pytest.mark.parametrize("rows", [16, 32])
def test_wide_select_tree_matches_jax_window_tree_per_lane(monkeypatch,
                                                            rows):
    """K7's partials at 16 and 32 rows equal, lane by lane, the JAX
    package's own XLA window step (ops/ed25519.py _select17,
    _cond_neg_point, _tree_reduce: lane i adds lane i + half) run on each
    block's lanes, block-major as the Pallas kernels lay them out."""
    import jax.numpy as jnp

    from cometbft_tpu.ops import ed25519 as jdev

    out_l, nblk = 2, 2
    blk = rows * out_l
    monkeypatch.setattr(cuda_msm, "OUT_PER_BLK", out_l)
    tab, mags, negs, _ = _inputs(nblk * blk, 2, 60 + rows)
    for j in (0, 1):
        got = cuda_msm.select_tree(tab, mags[j], negs[j], blk)
        jt = jnp.asarray(tab.numpy()).reshape(17, 4, 20, nblk, blk)
        pts = jdev._cond_neg_point(
            jdev._select17(jt, jnp.asarray(mags[j].numpy()).reshape(nblk,
                                                                     blk)),
            jnp.asarray(negs[j].numpy()).reshape(nblk, blk))
        want = jdev._tree_reduce(pts, out_l).reshape(4, 20, nblk * out_l)
        assert _affine(got) == _affine(want)


# -- (b) K6 is K7's recurrence at wide blocks ---------------------------------

@pytest.mark.parametrize("rows, out_l, w", [
    (8, 128, 1024 + 77),      # blk 1,024 at the real OUT_PER_BLK
    (16, 4, 64 + 37),
    (32, 4, 128 + 5),
])
def test_window_loop_is_select_tree_recurrence(monkeypatch, rows, out_l, w):
    """K6's partials are K7's window partials run through the Straus
    step, limb for limb, with a ragged last block (lanes past W the
    identity)."""
    monkeypatch.setattr(cuda_msm, "OUT_PER_BLK", out_l)
    blk, nwin = rows * out_l, 3
    tab, mags, negs, _ = _inputs(w, nwin, rows + w)
    got = cuda_msm.msm_window_loop(tab, mags, negs, blk)
    assert got.shape == (4, 20, -(-w // blk) * out_l)
    acc = cuda_msm.select_tree(tab, mags[0], negs[0], blk)
    for j in range(1, nwin):
        acc = tdev.straus_step(acc, cuda_msm.select_tree(tab, mags[j],
                                                         negs[j], blk))
    assert torch.equal(got, acc)


# -- (c) the geometry check ----------------------------------------------------

@pytest.mark.parametrize("blk, geometry", [
    (1024, (1024, 128, 10)), (2048, (2048, 128, 5)),
    (4096, (4096, 128, 3)), (8192, (8192, 128, 2)), (96, (96, 96, 107)),
    (128, (128, 128, 80))])
def test_loop_geometry_takes_power_of_two_rows(blk, geometry):
    assert cuda_msm.loop_geometry(10240, blk) == geometry


@pytest.mark.parametrize("blk, match", [
    (384, "power of two"), (640, "power of two"), (3072, "power of two"),
    (0, "positive"), (-128, "positive")])
def test_loop_geometry_refuses(blk, match):
    """3, 5 and 24 rows are not powers of two; a block below 1 lane has
    no row."""
    with pytest.raises(ValueError, match=match):
        cuda_msm.loop_geometry(10240, blk)


# -- (d) the kernel's schedule against the plain order ------------------------

def _bitrev(i, bits):
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def _quad_schedule(pts, w_pad, blk, out_l, qt):
    """pts: (4, 20, w_pad) one window's selected rows (lanes past W the
    identity) -> (4, 20, nout): the window-sum kernel's schedule for qt
    quads per task, every task at once, from its own lane arithmetic."""
    nout = w_pad // blk * out_l
    g = torch.arange(nout)
    m = blk // out_l // qt
    step = qt * out_l
    quads = []
    for h in range(qt):
        base = g // out_l * blk + g % out_l + h * out_l
        if m == 1:
            quads.append(pts[..., base])
            continue
        leaves = m // 2
        bits = leaves.bit_length() - 1
        half = leaves * step
        pending = {}
        for i in range(leaves):
            left = base + _bitrev(i, bits) * step
            v = tdev.add_cached(pts[..., left],
                                tdev.to_cached(pts[..., left + half]))
            lvl = 0
            while (i >> lvl) & 1:
                v = tdev.point_add(pending.pop(lvl), v)
                lvl += 1
            if i + 1 < leaves:
                pending[lvl] = v
        assert not pending
        quads.append(v)
    s = qt // 2
    while s >= 1:
        quads = [tdev.point_add(quads[h], quads[h + s]) for h in range(s)]
        s //= 2
    return quads[0]


def test_leaves_cover_each_task_once():
    """Over the quads and leaves of a task, every row is read once."""
    blk, out_l = 64, 4
    for qt in QUADS:
        m = blk // out_l // qt
        for g in range(2 * out_l):
            lanes = []
            for h in range(qt):
                base = g // out_l * blk + g % out_l + h * out_l
                if m == 1:
                    lanes.append(base)
                    continue
                bits = (m // 2).bit_length() - 1
                for i in range(m // 2):
                    left = base + _bitrev(i, bits) * qt * out_l
                    lanes += [left, left + m // 2 * qt * out_l]
            start = g // out_l * blk + g % out_l
            assert sorted(lanes) == list(range(start, start + blk, out_l))


@pytest.mark.parametrize("rows", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("w", [5, 50])
def test_quad_schedule_equals_block_contrib(monkeypatch, rows, w):
    """The schedule equals _block_contrib limb for limb for every qt <=
    r, at ragged widths (a part of one block, a part of the last), two
    output lanes per block."""
    out_l = 2 if rows > 1 else 4
    monkeypatch.setattr(cuda_msm, "OUT_PER_BLK", out_l)
    blk = rows * out_l
    tab, mags, negs, _ = _inputs(w, 1, 7 * rows + w)
    want = cuda_msm._block_contrib(tab, mags[0], negs[0], blk)
    w_pad = -(-w // blk) * blk
    pts = cuda_msm._select_signed(tab, mags[0], negs[0], w_pad)
    for qt in QUADS:
        if qt <= rows:
            assert torch.equal(_quad_schedule(pts, w_pad, blk, out_l, qt),
                               want), qt
