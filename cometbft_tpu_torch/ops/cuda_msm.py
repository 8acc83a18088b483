"""Kernels K2-K7 of the RLC verify path — negated window tables, the
Straus MSM in its engine configurations (window-major, grouped
window-major, window-loop, per-window select-tree) and the fold/verify
epilogue — with their plain torch versions, and the block and group
helpers of the JAX package's `pallas_msm.py` that choose their shapes.

K2 `table17_neg` replaces `cometbft_tpu/ops/pallas_msm.py::table17_neg`
(`_table17_neg_kernel`, pallas_call at :417).  A thread quad per point
writes the 17 rows k*(-P), one coordinate per thread: the 15 cached adds
run in series, each as two rounds of four products, one per thread
(`fe25519_quad.cuh`, limb for limb the sequential formulas).  Bound on
the H100: operations (15 cached adds of 8 products, 1 to_cached
product); the 5,440-byte table per lane is written once.

K3 `msm_window_major` replaces `pallas_msm.py::msm_window_major`
(`_window_major_kernel`, pallas_call at :498).  The TPU kernel sums each
window over all blocks, then runs the doubling chain once on one
accumulator.  Here the lanes are cut into k chunks (msm_geometry) and
two launches keep that split: every (window, chunk) sum S[j][c] in
parallel across the card, with no doubling in it, then one Horner chain
per chunk, acc <- 32 acc + S[j][c] in MSB order, whose result is
partial c (the recurrence is linear, so the partials' lane sum is the
MSM).  Each point operation runs on a thread quad, one coordinate per
thread, so a Straus step is 12 field products in series rather than
about 50.  Bound: operations (one point add per lane and window); the
chain's (nwin - 1) Straus steps are the latency floor of the method.

K5 `msm_window_major_grouped` replaces `msm_window_major(group > 1)`
(`_window_major_grouped_kernel`, pallas_call at :624): partials of
GROUP_LANES-lane blocks, split as K3 is: GROUP_QUADS thread quads per
(window, block) reduce the block's 32 selected rows by the pairwise
tree, a quad holding eight lanes (levels 16, 8 and 4 inside the quad, 2
and 1 across quads), all windows at once across the card; then K3's
Horner kernel closes each block's windows in MSB order.  The group is
checked and changes nothing on the card: a quad reads only its own
lanes' rows, so there is no table fetch for a group to share.

K6 `msm_window_loop` replaces `pallas_msm.py::msm_window_loop`
(`_window_loop_kernel`, pallas_call at :317), and K7 `select_tree`
replaces `pallas_msm.py::select_tree` (`_select_tree_kernel`,
pallas_call at :360).  Both keep the Pallas partial layout: blocks of
`blk` lanes, each halved pairwise down to `_out_lanes(blk)` output
lanes, block-major.  Both are one window-sum kernel on thread quads:
task (window, output lane) sums the lane's r = blk / out_l selected rows
in the plain halving order, one to eight quads per task (the leaves and
the levels above them depth first inside a quad, the last levels across
quads by shuffles), all tasks across the card at once.  K7 runs it on
its one window; K6 on every window into a scratch, then K3's Horner
chains, one per output lane.  r may be any power of two, as in the JAX
package.  Bound: operations (one point add per row and window, K6's
Straus steps); K6's chain of (nwin - 1) Straus steps is its floor.

K4 `fold_verify` replaces `pallas_msm.py::fold_verify`
(`_make_fold_kernel`, pallas_call at :730).  One block of FOLD_THREADS
slots, one thread quad each: strided per-slot sums over both sides'
partials, a pairwise tree over the slots (across warps through shared
memory, then by shuffles) in place of the `pltpu.roll` butterfly, 3
cofactor doublings and the frozen identity test.  Bound: operations,
one point add per partial; the time is the chain of about ten point
operations in series, each 2-3 product rounds on a quad.  It takes any
widths, so the JAX package's `_prefold` and its MAX_FOLD_LANES bound
have no counterpart here.

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

MSM_WARPS = 4            # warps of a K3 window-sum block: csrc MSM_WARPS
MSM_HOLDERS = 8 * MSM_WARPS   # point-holding quads per K3 window-sum block
MSM_MAX_ROWS = 32        # most lanes one K3 holder sums per window
MSM_MIN_BLOCKS = 132     # K3 window-sum blocks to aim for: 1 per H100 SM
CHAIN_THREADS = 32       # threads of a K3 Horner block: csrc CHAIN_THREADS
GROUP_LANES = 32         # lanes per K5 block: the plain tree's width
FOLD_THREADS = 128       # K4 fold slots, a thread quad each: csrc FOLD_SLOTS
LOOP_THREADS = 128       # threads per K6 / K7 block: csrc LOOP_THREADS
GROUP_WARPS = 4          # warps of a K5 window-sum block: csrc GROUP_WARPS
GROUP_QUADS = 4          # thread quads per K5 window sum: csrc GROUP_QUADS


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
    "ed25519_kernels": {"ed25519_msm_warps": MSM_WARPS,
                        "ed25519_chain_threads": CHAIN_THREADS,
                        "ed25519_fold_slots": FOLD_THREADS},
    "ed25519_engines": {"ed25519_loop_threads": LOOP_THREADS,
                        "ed25519_group_warps": GROUP_WARPS,
                        "ed25519_group_quads": GROUP_QUADS},
}


def _lib(name: str = "ed25519_kernels"):
    from . import _build

    lib = _build.load(name)
    sizes = {fn: getattr(lib, fn)() for fn in _LIB_SIZES[name]}
    if sizes != _LIB_SIZES[name]:
        raise _build.KernelBuildError(f"{name} block sizes {sizes} differ "
                                      "from ops/cuda_msm.py")
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
    devmod.count_launch(table17_neg)
    return tab


table17_neg.launches = 0


# ---------------------------------------------------------------------------
# K3: window-major Straus MSM -> one partial per lane chunk
# ---------------------------------------------------------------------------

def _block_tree(pts: torch.Tensor) -> torch.Tensor:
    """(4, 20, ..., n) -> (4, 20, ...) by pairwise halving, lane i adding
    lane i + half — the kernels' tree order."""
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


def msm_geometry(w: int, nwin: int):
    """K3's (rows, chunk, k) at width w and nwin windows: each of the
    MSM_HOLDERS holders of a chunk sums `rows` lanes, a chunk is
    MSM_HOLDERS * rows lanes, k = ceil(w / chunk) chunks and partials.
    rows is the largest power of two up to MSM_MAX_ROWS that still gives
    nwin * k >= MSM_MIN_BLOCKS window-sum blocks, else 1."""
    rows = MSM_MAX_ROWS
    while rows > 1 and nwin * -(-w // (MSM_HOLDERS * rows)) < MSM_MIN_BLOCKS:
        rows //= 2
    chunk = MSM_HOLDERS * rows
    return rows, chunk, -(-w // chunk)


def msm_window_sums_plain(tab, mags, negs):
    """(17, 4, 20, W) tables, (nwin, W) digits -> (4, 20, nwin, k): the
    kernel's window sums.  Holder h of chunk c sums lanes
    c * chunk + i * MSM_HOLDERS + h for i = 0 .. rows-1 in order; the
    holders are halved pairwise within each warp's 8, then across the
    MSM_WARPS warps."""
    nwin, w = mags.shape
    rows, chunk, k = msm_geometry(w, nwin)
    pts = torch.stack([_select_signed(tab, mags[j], negs[j], k * chunk)
                       for j in range(nwin)], dim=2)
    pts = pts.reshape(4, fe.NLIMBS, nwin, k, rows, MSM_HOLDERS)
    acc = pts[..., 0, :]
    for i in range(1, rows):
        acc = _ed().point_add(acc, pts[..., i, :])
    acc = acc.reshape(4, fe.NLIMBS, nwin, k, MSM_WARPS, 8)
    return _block_tree(_block_tree(acc))


def msm_window_major_plain(tab, mags, negs):
    """(17, 4, 20, W) negated tables, (nwin, W) magnitudes and signs,
    MSB-first -> (4, 20, k) partials, k from msm_geometry, whose lane
    sum is sum_i e_i * (-P_i): the window sums, then per chunk the
    Horner chain acc <- straus_step(acc, S[j]) in window order."""
    sums = msm_window_sums_plain(tab, mags, negs)
    acc = sums[:, :, 0]
    for j in range(1, sums.shape[2]):
        acc = _ed().straus_step(acc, sums[:, :, j])
    return acc


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
    rows, _, k = msm_geometry(w, nwin)
    sums = torch.empty((nwin, 4, fe.NLIMBS, k), dtype=torch.int32,
                       device=tab.device)
    out = torch.empty((4, fe.NLIMBS, k), dtype=torch.int32,
                      device=tab.device)
    lib = _lib()
    with torch.cuda.device(tab.device):
        rc = lib.ed25519_msm_window_major(
            devmod.ptr(tab), devmod.ptr(mags), devmod.ptr(negs), w, nwin,
            rows, k, devmod.ptr(sums), devmod.ptr(out), devmod.stream(tab))
    devmod.check_launch(rc, "ed25519_msm_window_major")
    devmod.count_launch(msm_window_major)
    return out


msm_window_major.launches = 0


# ---------------------------------------------------------------------------
# K5: grouped window-major MSM -> one partial per 32-lane block
# ---------------------------------------------------------------------------

def msm_window_major_grouped_plain(tab, mags, negs, group: int):
    """(4, 20, ceil(W / 32)) partials: each 32-lane block's window tree
    (lane t adding lane t + s), then the windows closed in MSB order with
    one accumulator per block.  The grouped kernel only schedules these
    operations group by group, so the group does not change the result."""
    nblk = -(-tab.shape[-1] // GROUP_LANES)
    acc = None
    for j in range(mags.shape[0]):
        pts = _select_signed(tab, mags[j], negs[j], nblk * GROUP_LANES)
        sums = _block_tree(pts.reshape(4, fe.NLIMBS, nblk, GROUP_LANES))
        acc = sums if acc is None else _ed().straus_step(acc, sums)
    return acc


def msm_window_major_grouped(tab, mags, negs, group: int):
    nwin = mags.shape[0]
    if group < 1 or nwin % group:
        raise ValueError(f"window group {group} does not divide {nwin} "
                         "windows")
    if not tab.is_cuda:
        return msm_window_major_grouped_plain(tab, mags, negs, group)
    tab, mags, negs = _require_msm(tab, mags, negs)
    w = tab.shape[-1]
    nblk = -(-w // GROUP_LANES)
    sums = torch.empty((nwin, 4, fe.NLIMBS, nblk), dtype=torch.int32,
                       device=tab.device)
    out = torch.empty((4, fe.NLIMBS, nblk), dtype=torch.int32,
                      device=tab.device)
    lib = _lib("ed25519_engines")
    with torch.cuda.device(tab.device):
        rc = lib.ed25519_msm_window_major_grouped(
            devmod.ptr(tab), devmod.ptr(mags), devmod.ptr(negs), w, nwin,
            devmod.ptr(sums), devmod.ptr(out), devmod.stream(tab))
    devmod.check_launch(rc, "ed25519_msm_window_major_grouped")
    devmod.count_launch(msm_window_major_grouped)
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
    if blk % out_l or rows & (rows - 1):
        raise ValueError(f"block size {blk}: the halving tree needs blk / "
                         f"{out_l} to be a power of two")
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
    sums = torch.empty((nwin, 4, fe.NLIMBS, nblk * out_l), dtype=torch.int32,
                       device=tab.device)
    out = torch.empty((4, fe.NLIMBS, nblk * out_l), dtype=torch.int32,
                      device=tab.device)
    lib = _lib("ed25519_engines")
    with torch.cuda.device(tab.device):
        rc = lib.ed25519_msm_window_loop(
            devmod.ptr(tab), devmod.ptr(mags), devmod.ptr(negs), w, nwin,
            blk, out_l, nblk * out_l, devmod.ptr(sums), devmod.ptr(out),
            devmod.stream(tab))
    devmod.check_launch(rc, "ed25519_msm_window_loop")
    devmod.count_launch(msm_window_loop)
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
    devmod.count_launch(select_tree)
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
    devmod.count_launch(fold_verify)
    return out[0] != 0


fold_verify.launches = 0
