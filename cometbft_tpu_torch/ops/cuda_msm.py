"""Kernels K2-K4 of the RLC verify path — negated window tables, the
window-major Straus MSM and the fold/verify epilogue — with their plain
torch versions.

K2 `table17_neg` replaces `cometbft_tpu/ops/pallas_msm.py::table17_neg`
(`_table17_neg_kernel`, pallas_call at :417).  One thread per point
writes the 17 rows k*(-P).  Bound on the H100: operations (15 cached
adds of 8 products, 1 to_cached product); the 5,440-byte table per lane
is written once.

K3 `msm_window_major` replaces `pallas_msm.py::msm_window_major`
(`_window_major_kernel`, pallas_call at :498).  The TPU runs its grid in
order and carries one accumulator across grid steps; CUDA blocks run in
no order, so each block owns MSM_LANES lanes and keeps its own
accumulator over every window (the Straus recurrence is linear, so the
lane sum of the per-block partials is the MSM).  Per window a thread
reads only its lane's row |d| from the table in device memory, a
shared-memory tree reduces the block, and one thread runs the 5
doublings and the add.  Bound: operations (one point add per lane and
window, plus 6 point operations per block and window); the serial
per-block doubling chain is what this first design pays for its
simplicity.

K4 `fold_verify` replaces `pallas_msm.py::fold_verify`
(`_make_fold_kernel`, pallas_call at :730).  One block: strided
per-thread sums over both sides' partials, a shared-memory tree in place
of the `pltpu.roll` butterfly, 3 cofactor doublings and the frozen
identity test.  It takes any widths, so the JAX package's `_prefold`
and its MAX_FOLD_LANES bound have no counterpart here.

Every wrapper runs its plain version for a CPU tensor and launches its
kernel for a CUDA tensor (or raises); `launches` counts the launches.
The plain versions run the kernels' algorithm in the same order — the
same block width, the same pairwise tree — so a kernel and its plain
version agree limb for limb.
"""

from __future__ import annotations

import torch

from . import device as devmod
from . import fe

MSM_LANES = 32           # lanes per K3 block: csrc MSM_LANES
FOLD_THREADS = 128       # threads of the K4 block: csrc FOLD_THREADS


def _ed():
    from . import ed25519
    return ed25519


def _lib():
    from . import _build

    lib = _build.load("ed25519_kernels")
    if (lib.ed25519_msm_lanes(), lib.ed25519_fold_threads()) != (
            MSM_LANES, FOLD_THREADS):
        raise RuntimeError("kernel library block sizes differ from "
                           "ops/cuda_msm.py")
    return lib


# ---------------------------------------------------------------------------
# K2: negated 17-row window tables
# ---------------------------------------------------------------------------

def table17_neg_plain(pt: torch.Tensor) -> torch.Tensor:
    """(4, 20, W) -> (17, 4, 20, W) rows k*(-P), k = 0..16."""
    ed = _ed()
    return ed._table17(ed.point_neg(pt))


def table17_neg(pt: torch.Tensor) -> torch.Tensor:
    if not pt.is_cuda:
        return table17_neg_plain(pt)
    devmod.require(pt, "table17_neg points", torch.int32,
                   (4, fe.NLIMBS, None))
    pt = pt.contiguous()
    w = pt.shape[-1]
    tab = torch.empty((17, 4, fe.NLIMBS, w), dtype=torch.int32,
                      device=pt.device)
    lib = _lib()
    with torch.cuda.device(pt.device):
        rc = lib.ed25519_table17_neg(devmod.ptr(pt), w, devmod.ptr(tab),
                                     devmod.stream(pt))
    devmod.check_launch(rc, "ed25519_table17_neg")
    table17_neg.launches += 1
    return tab


table17_neg.launches = 0


# ---------------------------------------------------------------------------
# K3: window-major Straus MSM -> per-block partials
# ---------------------------------------------------------------------------

def _block_tree(pts: torch.Tensor) -> torch.Tensor:
    """(4, 20, ..., n) -> (4, 20, ...) by pairwise halving, lane i adding
    lane i + half — the kernels' shared-memory tree order."""
    ed = _ed()
    width = pts.shape[-1]
    while width > 1:
        half = width // 2
        pts = ed.point_add(pts[..., :half], pts[..., half:width])
        width = half
    return pts[..., 0]


def msm_window_major_plain(tab, mags, negs):
    """(17, 4, 20, W) negated tables, (nwin, W) magnitudes 0..16 and
    signs, MSB-first -> (4, 20, ceil(W / MSM_LANES)) partials whose lane
    sum is sum_i e_i * (-P_i)."""
    ed = _ed()
    w = tab.shape[-1]
    nblk = -(-w // MSM_LANES)
    pad = nblk * MSM_LANES - w
    acc = None
    for j in range(mags.shape[0]):
        idx = mags[j].long().reshape(1, 1, 1, w).expand(1, 4, fe.NLIMBS, w)
        sel = torch.gather(tab, 0, idx)[0]
        flip = negs[j].bool()[None]
        pts = torch.stack([torch.where(flip, -sel[0], sel[0]), sel[1],
                           sel[2], torch.where(flip, -sel[3], sel[3])])
        if pad:
            pts = torch.cat([pts, ed.identity_point((pad,), pts.device)],
                            dim=-1)
        contrib = _block_tree(pts.reshape(4, fe.NLIMBS, nblk, MSM_LANES))
        if acc is None:
            acc = contrib
            continue
        for _ in range(4):
            acc = ed.point_double(acc, with_t=False)
        acc = ed.point_double(acc, with_t=True)
        acc = ed.point_add(acc, contrib)
    return acc


def msm_window_major(tab, mags, negs):
    if not tab.is_cuda:
        return msm_window_major_plain(tab, mags, negs)
    w = tab.shape[-1]
    nwin = mags.shape[0]
    devmod.require(tab, "msm table", torch.int32, (17, 4, fe.NLIMBS, None))
    devmod.require(mags, "msm magnitudes", torch.int32, (nwin, w))
    devmod.require(negs, "msm signs", torch.bool, (nwin, w))
    if nwin < 1:
        raise ValueError("msm_window_major needs at least one window")
    tab, mags = tab.contiguous(), mags.contiguous()
    negs = negs.contiguous().view(torch.uint8)
    nblk = -(-w // MSM_LANES)
    out = torch.empty((4, fe.NLIMBS, nblk), dtype=torch.int32,
                      device=tab.device)
    lib = _lib()
    with torch.cuda.device(tab.device):
        rc = lib.ed25519_msm_window_major(
            devmod.ptr(tab), devmod.ptr(mags), devmod.ptr(negs), w, nwin,
            devmod.ptr(out), devmod.stream(tab))
    devmod.check_launch(rc, "ed25519_msm_window_major")
    msm_window_major.launches += 1
    return out


msm_window_major.launches = 0


# ---------------------------------------------------------------------------
# K4: fold both sides, cofactor, identity test
# ---------------------------------------------------------------------------

def fold_verify_plain(pa: torch.Tensor, pr: torch.Tensor) -> torch.Tensor:
    """(4, 20, na), (4, 20, nr) partials -> 0-dim bool:
    [8] * (sum(pa) + sum(pr)) == identity."""
    ed = _ed()
    cat = torch.cat([pa, pr], dim=-1)
    n = cat.shape[-1]
    m = -(-n // FOLD_THREADS)
    pad = m * FOLD_THREADS - n
    if pad:
        cat = torch.cat([cat, ed.identity_point((pad,), cat.device)], dim=-1)
    cat = cat.reshape(4, fe.NLIMBS, m, FOLD_THREADS)
    lane = torch.arange(FOLD_THREADS, device=cat.device)
    acc = ed.identity_point((FOLD_THREADS,), cat.device)
    for it in range(m):
        live = (it * FOLD_THREADS + lane < n)[None, None]
        acc = torch.where(live, ed.point_add(acc, cat[..., it, :]), acc)
    tot = _block_tree(acc)[..., None]
    for _ in range(3):               # cofactor 8
        tot = ed.point_double(tot, with_t=False)
    return ed.point_is_identity(tot)[0]


def fold_verify(pa: torch.Tensor, pr: torch.Tensor) -> torch.Tensor:
    if not pa.is_cuda:
        return fold_verify_plain(pa, pr)
    devmod.require(pa, "fold A partials", torch.int32, (4, fe.NLIMBS, None))
    devmod.require(pr, "fold R partials", torch.int32, (4, fe.NLIMBS, None))
    pa, pr = pa.contiguous(), pr.contiguous()
    out = torch.empty((1,), dtype=torch.int32, device=pa.device)
    lib = _lib()
    with torch.cuda.device(pa.device):
        rc = lib.ed25519_fold_verify(
            devmod.ptr(pa), pa.shape[-1], devmod.ptr(pr), pr.shape[-1],
            devmod.ptr(out), devmod.stream(pa))
    devmod.check_launch(rc, "ed25519_fold_verify")
    fold_verify.launches += 1
    return out[0] != 0


fold_verify.launches = 0
