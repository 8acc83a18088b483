"""Kernels K2-K7 of the RLC verify path — negated window tables, the
Straus MSM in its engine configurations (window-major, grouped
window-major, window-loop, per-window select-tree) and the fold/verify
epilogue — with their plain torch versions, and the block and group
helpers of the JAX package's `pallas_msm.py` that choose their shapes.

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

K5 `msm_window_major_grouped` replaces `msm_window_major(group > 1)`
(`_window_major_grouped_kernel`, pallas_call at :624): K3's partials,
with the block's warps reducing the G windows of a group in parallel
and one thread closing the group.  Same operations in the same order as
K3, so the two agree limb for limb.

K6 `msm_window_loop` replaces `pallas_msm.py::msm_window_loop`
(`_window_loop_kernel`, pallas_call at :317), and K7 `select_tree`
replaces `pallas_msm.py::select_tree` (`_select_tree_kernel`,
pallas_call at :360).  Both keep the Pallas partial layout: blocks of
`blk` lanes, each halved pairwise down to `_out_lanes(blk)` output
lanes, block-major.  One thread per output lane; K6 carries the lane's
accumulator over all windows, K7 computes one window.

K4 `fold_verify` replaces `pallas_msm.py::fold_verify`
(`_make_fold_kernel`, pallas_call at :730).  One block: strided
per-thread sums over both sides' partials, a shared-memory tree in place
of the `pltpu.roll` butterfly, 3 cofactor doublings and the frozen
identity test.  It takes any widths, so the JAX package's `_prefold`
and its MAX_FOLD_LANES bound have no counterpart here.

The MSM kernels take any width: where the JAX package finds no legal
block (`blk_for` is None) it runs XLA, while here lanes past W
contribute the identity.  A digit magnitude outside 0..16 selects row
0, the identity, as the JAX select cascade does.

Every wrapper runs its plain version for a CPU tensor and launches its
kernel for a CUDA tensor (or raises); `launches` counts the launches.
The plain versions run the kernels' algorithm in the same order — the
same block width, the same pairwise tree — so a kernel and its plain
version agree limb for limb.
"""

from __future__ import annotations

import os

import torch

from . import device as devmod
from . import fe

MSM_LANES = 32           # lanes per K3 / K5 block: csrc MSM_LANES
FOLD_THREADS = 128       # threads of the K4 block: csrc FOLD_THREADS
LOOP_THREADS = 128       # threads per K6 / K7 block: csrc LOOP_THREADS
LOOP_MAX_ROWS = 8        # most rows a K6 / K7 thread sums: csrc LOOP_MAX_ROWS
GROUP_WARPS = 4          # warps of a K5 block: csrc GROUP_WARPS


# ---------------------------------------------------------------------------
# block and group sizes (the port's copies of pallas_msm.py's helpers,
# reading the same environment variables)
# ---------------------------------------------------------------------------

# Lanes per window-loop / select-tree block.
BLK = int(os.environ.get("COMETBFT_TPU_PALLAS_BLK", "512"))

# Partials each block writes (cap): the halving tree stops at 128 lanes.
OUT_PER_BLK = 128

# Windows per grouped window-major pass (1: plain window-major, K3).
WIN_GROUP = int(os.environ.get("COMETBFT_TPU_PALLAS_WIN_GROUP", "1"))


def blk_for(w: int):
    """Largest block size from BLK halving down to 128 that divides
    width w, or None.  Below 128 a block may be any size that divides w;
    at or above 128 blocks are powers of two (a non-pow2 BLK rounds
    down), so the halving tree lands exactly on the 128 output lanes."""
    b = BLK
    if b <= 0:
        return None
    if b < 128 and w % b == 0:
        return b
    b = 1 << (b.bit_length() - 1)
    floor = min(128, b)
    while b >= floor:
        if w % b == 0:
            return b
        b //= 2
    return None


def _out_lanes(blk: int) -> int:
    """Lanes each block's partial occupies for a given block size."""
    return min(blk, OUT_PER_BLK)


def loop_blk(w: int) -> int:
    """The block K6 and K7 use at width w: blk_for(w), or for a width
    with no legal block (every width below 128 at BLK 512, and widths
    such as 160, 192 and 320) BLK itself, rounded down to a power of two
    at or above 128, with a ragged last block whose lanes past w add the
    identity."""
    b = blk_for(w)
    if b is not None:
        return b
    if BLK <= 0:
        raise ValueError(f"COMETBFT_TPU_PALLAS_BLK must be positive, "
                         f"got {BLK}")
    return BLK if BLK < 128 else 1 << (BLK.bit_length() - 1)


def group_for(nwin: int, requested: int) -> int:
    """Largest divisor of nwin that is <= requested (52-window A sides
    admit {2, 4, 13}, 26-window R sides {2, 13})."""
    g = 1
    for c in range(2, min(requested, nwin) + 1):
        if nwin % c == 0:
            g = c
    return g


def _ed():
    from . import ed25519
    return ed25519


# each library's block sizes, which the launches below assume
_LIB_SIZES = {
    "ed25519_kernels": {"ed25519_msm_lanes": MSM_LANES,
                        "ed25519_fold_threads": FOLD_THREADS},
    "ed25519_engines": {"ed25519_loop_threads": LOOP_THREADS,
                        "ed25519_loop_max_rows": LOOP_MAX_ROWS,
                        "ed25519_group_warps": GROUP_WARPS},
}


def _lib(name: str = "ed25519_kernels"):
    from . import _build

    lib = _build.load(name)
    sizes = {fn: getattr(lib, fn)() for fn in _LIB_SIZES[name]}
    if sizes != _LIB_SIZES[name]:
        raise RuntimeError(f"{name} block sizes {sizes} differ from "
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


def _select_signed(tab, mag, neg, lanes: int):
    """One window's signed rows (4, 20, lanes): row |d| of each lane,
    X and T negated where the sign is set; lanes past W (up to `lanes`)
    and magnitudes outside 0..16 give the identity."""
    ed = _ed()
    pts = ed._cond_neg_point(ed._select17(tab, mag), neg.bool())
    pad = lanes - pts.shape[-1]
    if pad:
        pts = torch.cat([pts, ed.identity_point((pad,), pts.device)], dim=-1)
    return pts


def _window_sums(tab, mag, neg):
    """One window's per-32-lane-block sums, (4, 20, ceil(W / 32))."""
    nblk = -(-tab.shape[-1] // MSM_LANES)
    pts = _select_signed(tab, mag, neg, nblk * MSM_LANES)
    return _block_tree(pts.reshape(4, fe.NLIMBS, nblk, MSM_LANES))


def _window_major(tab, mags, negs):
    acc = _window_sums(tab, mags[0], negs[0])
    for j in range(1, mags.shape[0]):
        acc = _ed().straus_step(acc, _window_sums(tab, mags[j], negs[j]))
    return acc


def msm_window_major_plain(tab, mags, negs):
    """(17, 4, 20, W) negated tables, (nwin, W) magnitudes and signs,
    MSB-first -> (4, 20, ceil(W / MSM_LANES)) partials whose lane sum is
    sum_i e_i * (-P_i)."""
    return _window_major(tab, mags, negs)


def _require_msm(tab, mags, negs):
    w = tab.shape[-1]
    nwin = mags.shape[0]
    devmod.require(tab, "msm table", torch.int32, (17, 4, fe.NLIMBS, None))
    devmod.require(mags, "msm magnitudes", torch.int32, (nwin, w))
    devmod.require(negs, "msm signs", torch.bool, (nwin, w))
    if nwin < 1:
        raise ValueError("the MSM needs at least one window")
    return (tab.contiguous(), mags.contiguous(),
            negs.contiguous().view(torch.uint8))


def msm_window_major(tab, mags, negs, group=None):
    """K3, or K5 when group_for(nwin, group) > 1; group defaults to
    WIN_GROUP (the JAX package's msm_window_major(group=None))."""
    g = group_for(mags.shape[0], WIN_GROUP if group is None else group)
    if g > 1:
        return msm_window_major_grouped(tab, mags, negs, g)
    if not tab.is_cuda:
        return msm_window_major_plain(tab, mags, negs)
    tab, mags, negs = _require_msm(tab, mags, negs)
    w, nwin = tab.shape[-1], mags.shape[0]
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
# K5: grouped window-major MSM -> K3's partials
# ---------------------------------------------------------------------------

def msm_window_major_grouped_plain(tab, mags, negs, group: int):
    """K3's partials: the grouped kernel runs K3's operations in K3's
    order (each window's 32-lane tree, then the windows closed in MSB
    order), only scheduled group by group, so its plain version is
    K3's."""
    return _window_major(tab, mags, negs)


def msm_window_major_grouped(tab, mags, negs, group: int):
    nwin = mags.shape[0]
    if group < 1 or nwin % group:
        raise ValueError(f"window group {group} does not divide {nwin} "
                         "windows")
    if not tab.is_cuda:
        return msm_window_major_grouped_plain(tab, mags, negs, group)
    tab, mags, negs = _require_msm(tab, mags, negs)
    w = tab.shape[-1]
    out = torch.empty((4, fe.NLIMBS, -(-w // MSM_LANES)), dtype=torch.int32,
                      device=tab.device)
    lib = _lib("ed25519_engines")
    with torch.cuda.device(tab.device):
        rc = lib.ed25519_msm_window_major_grouped(
            devmod.ptr(tab), devmod.ptr(mags), devmod.ptr(negs), w, nwin,
            group, devmod.ptr(out), devmod.stream(tab))
    devmod.check_launch(rc, "ed25519_msm_window_major_grouped")
    msm_window_major_grouped.launches += 1
    return out


msm_window_major_grouped.launches = 0


# ---------------------------------------------------------------------------
# K6 / K7: per-block partials over blk-lane blocks
# ---------------------------------------------------------------------------

def loop_geometry(w: int, blk):
    """(blk, out lanes per block, blocks) for width w; blk None takes
    loop_blk(w)."""
    blk = loop_blk(w) if blk is None else blk
    if blk < 1:
        raise ValueError(f"block size {blk} must be positive")
    out_l = _out_lanes(blk)
    rows = blk // out_l
    if blk % out_l or rows & (rows - 1) or rows > LOOP_MAX_ROWS:
        raise ValueError(f"block size {blk}: the halving tree needs blk / "
                         f"{out_l} to be a power of two <= {LOOP_MAX_ROWS}")
    return blk, out_l, -(-w // blk)


def _block_contrib(tab, mag, neg, blk):
    """One window's partials (4, 20, nblk * out_l): each blk-lane block
    selected and halved pairwise (lane L adds lane L + half) down to
    out_l lanes, block-major — pallas_msm._block_contrib per block."""
    blk, out_l, nblk = loop_geometry(tab.shape[-1], blk)
    pts = _select_signed(tab, mag, neg, nblk * blk)
    pts = pts.reshape(4, fe.NLIMBS, nblk, blk)
    width = blk
    while width > out_l:
        half = width // 2
        pts = _ed().point_add(pts[..., :half], pts[..., half:width])
        width = half
    return pts.reshape(4, fe.NLIMBS, nblk * out_l)


def msm_window_loop_plain(tab, mags, negs, blk=None):
    """(17, 4, 20, W) tables, (nwin, W) digits -> (4, 20, nblk * out_l)
    per-block accumulators whose lane sum is the MSM."""
    acc = _block_contrib(tab, mags[0], negs[0], blk)
    for j in range(1, mags.shape[0]):
        acc = _ed().straus_step(acc,
                                _block_contrib(tab, mags[j], negs[j], blk))
    return acc


def msm_window_loop(tab, mags, negs, blk=None):
    if not tab.is_cuda:
        return msm_window_loop_plain(tab, mags, negs, blk)
    tab, mags, negs = _require_msm(tab, mags, negs)
    w, nwin = tab.shape[-1], mags.shape[0]
    blk, out_l, nblk = loop_geometry(w, blk)
    out = torch.empty((4, fe.NLIMBS, nblk * out_l), dtype=torch.int32,
                      device=tab.device)
    lib = _lib("ed25519_engines")
    with torch.cuda.device(tab.device):
        rc = lib.ed25519_msm_window_loop(
            devmod.ptr(tab), devmod.ptr(mags), devmod.ptr(negs), w, nwin,
            blk, out_l, nblk * out_l, devmod.ptr(out), devmod.stream(tab))
    devmod.check_launch(rc, "ed25519_msm_window_loop")
    msm_window_loop.launches += 1
    return out


msm_window_loop.launches = 0


def select_tree_plain(tab, mag, neg, blk=None):
    """(17, 4, 20, W) tables, one window's (W,) digits -> (4, 20,
    nblk * out_l) partials."""
    return _block_contrib(tab, mag, neg, blk)


def select_tree(tab, mag, neg, blk=None):
    if not tab.is_cuda:
        return select_tree_plain(tab, mag, neg, blk)
    w = tab.shape[-1]
    devmod.require(tab, "select_tree table", torch.int32,
                   (17, 4, fe.NLIMBS, None))
    devmod.require(mag, "select_tree magnitudes", torch.int32, (w,))
    devmod.require(neg, "select_tree signs", torch.bool, (w,))
    tab, mag = tab.contiguous(), mag.contiguous()
    neg = neg.contiguous().view(torch.uint8)
    blk, out_l, nblk = loop_geometry(w, blk)
    out = torch.empty((4, fe.NLIMBS, nblk * out_l), dtype=torch.int32,
                      device=tab.device)
    lib = _lib("ed25519_engines")
    with torch.cuda.device(tab.device):
        rc = lib.ed25519_select_tree(
            devmod.ptr(tab), devmod.ptr(mag), devmod.ptr(neg), w, blk, out_l,
            nblk * out_l, devmod.ptr(out), devmod.stream(tab))
    devmod.check_launch(rc, "ed25519_select_tree")
    select_tree.launches += 1
    return out


select_tree.launches = 0


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
