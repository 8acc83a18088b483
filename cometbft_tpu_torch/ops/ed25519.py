"""Ed25519 batch verification on torch tensors: point arithmetic, the
RLC whole-batch program and the per-signature program — the port's
counterpart of `cometbft_tpu.ops.ed25519`.

Layout is the JAX package's: field elements (20, W), points (4, 20, W),
window tables (17, 4, 20, W), the batch axis minor.  The hot steps of
the RLC program go through the kernel wrappers of ops/cuda_decompress.py
(K1) and ops/cuda_msm.py (K2-K7): on a CUDA tensor each launches its
hand-written kernel, on a CPU tensor it runs its plain version.
Everything else here is plain torch on whatever device its inputs live
on.  The device-hash programs (rlc_verify_hash_kernel, verify_hash_kernel)
hash R||A||M on K9 (ops/sha2.py) and reduce, aggregate and recode in
torch ops before the same programs.

The MSM engine is chosen as in the JAX package, by the same environment
variables with the same defaults, read at import into the module flags
below (tests and chip_smoke.py flip the attributes):
  USE_PALLAS_MSM_MAJOR  window-major, K3 (K5 when WIN_GROUP > 1), default;
  USE_PALLAS_MSM_LOOP   window-loop K6, when window-major is off;
  USE_PALLAS_TREE       select-tree K7 inside the window scan, when both
                        are off;
  USE_PALLAS_FOLD       fused fold epilogue K4 over the partials; off,
                        each side reduces to one point and the epilogue is
                        torch point ops.
With all three MSM flags off the window scan is plain torch.  The JAX
flags USE_PALLAS_TABLE and USE_PALLAS_DECOMPRESS have no counterpart:
they only choose XLA over a kernel, and the port always runs K1 and K2.

Verification follows ZIP-215: non-canonical y accepted, cofactored
equation, s < L enforced host-side (crypto/ed25519.parse_signature).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import cuda_decompress, cuda_msm
from . import device as devmod
from . import fe
from . import limbs as lb
from . import msm as msm_engine
from . import scalar25519 as sc
from . import sha2
from ..crypto import ed25519_ref as ref

_X, _Y, _Z, _T = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# point representation: (4, 20, ...batch), coords on axis 0
# ---------------------------------------------------------------------------

def identity_point(batch_shape, device) -> torch.Tensor:
    one = devmod.constant(fe.ONE_LIMBS, device, torch.int32)
    one = one.reshape((fe.NLIMBS,) + (1,) * len(batch_shape)).expand(
        (fe.NLIMBS,) + tuple(batch_shape))
    zero = torch.zeros_like(one)
    return torch.stack([zero, one, one, zero], dim=0)


def point_double(p, with_t: bool = True):
    """dbl-2008-hwcd for a=-1: 4M+4S (3M+4S without T)."""
    x, y, z = p[_X], p[_Y], p[_Z]
    a = fe.sqr(x)
    b = fe.sqr(y)
    c = fe.mul_word(fe.sqr(z), 2)
    h = fe.add(a, b)
    e = fe.sub(h, fe.sqr(fe.add(x, y)))
    g = fe.sub(a, b)
    f = fe.add(c, g)
    t = fe.mul(e, h) if with_t else torch.zeros_like(x)
    return torch.stack([fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), t], dim=0)


def to_cached(p):
    """Extended -> cached (Y+X, Y-X, 2d*T, 2Z): one mul."""
    return torch.stack([fe.add(p[_Y], p[_X]),
                        fe.sub(p[_Y], p[_X]),
                        fe.mul(p[_T], fe.const(fe.D2_LIMBS, p[_T])),
                        fe.mul_word(p[_Z], 2)], dim=0)


def add_cached(p, q):
    """add-2008-hwcd-3 with q pre-cached: 8M, complete for a=-1."""
    a = fe.mul(fe.sub(p[_Y], p[_X]), q[1])
    b = fe.mul(fe.add(p[_Y], p[_X]), q[0])
    c = fe.mul(p[_T], q[2])
    d = fe.mul(p[_Z], q[3])
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return torch.stack([fe.mul(e, f), fe.mul(g, h), fe.mul(f, g),
                        fe.mul(e, h)], dim=0)


def point_add(p, q):
    """Extended + extended."""
    return add_cached(p, to_cached(q))


def straus_step(acc, p):
    """acc <- 32 * acc + p, one 5-bit window of the Straus recurrence:
    4 doublings without T, one with T, the add."""
    for _ in range(4):
        acc = point_double(acc, with_t=False)
    acc = point_double(acc, with_t=True)
    return point_add(acc, p)


def point_neg(p):
    return torch.stack([fe.neg(p[_X]), p[_Y], p[_Z], fe.neg(p[_T])], dim=0)


def point_is_identity(p):
    """[X:Y:Z:T] == identity <=> X == 0 and Y == Z (Z != 0 always)."""
    return fe.is_zero(p[_X]) & fe.eq(p[_Y], p[_Z])


# ---------------------------------------------------------------------------
# decompression (ZIP-215: no canonical-y check) — kernel K1
# ---------------------------------------------------------------------------

def decompress(enc_words: torch.Tensor):
    """(8, W) int32 bit patterns of LE words -> ((4, 20, W), (W,) ok)."""
    return cuda_decompress.decompress(enc_words)


# ---------------------------------------------------------------------------
# shared tree / table helpers
# ---------------------------------------------------------------------------

def _tree_reduce(pts, target: int = 1):
    """(4, 20, W) extended points -> (4, 20, target) by pairwise adds;
    odd widths carry the leftover lane."""
    while pts.shape[-1] > target:
        w = pts.shape[-1]
        half = w // 2
        left = point_add(pts[..., :half], pts[..., half:2 * half])
        if w % 2:
            left = torch.cat([left, pts[..., 2 * half:]], dim=-1)
        pts = left
    return pts


def _table17(p):
    """Rows k*P for k=0..16, extended coords, (17, 4, 20, W)."""
    p_cached = to_cached(p)
    rows = [identity_point(p.shape[2:], p.device), p]
    cur = p
    for _ in range(15):
        cur = add_cached(cur, p_cached)
        rows.append(cur)
    return torch.stack(rows, dim=0)


def build_a_tables(enc_words):
    """Decompress one MSM side (K1) and build its negated 17-row window
    tables (K2): (8, W) -> ((17, 4, 20, W), all-decompressed-ok).  The
    A side's result is what the ATableCache keeps."""
    pt, ok = decompress(enc_words)
    return cuda_msm.table17_neg(pt), ok.all()


# ---------------------------------------------------------------------------
# MSM engine configurations
# ---------------------------------------------------------------------------

NPART_MAX = 192      # max lane-resident partial accumulators (plain scan)

USE_PALLAS_TREE = os.environ.get("COMETBFT_TPU_PALLAS_TREE", "0") == "1"
USE_PALLAS_MSM_LOOP = os.environ.get(
    "COMETBFT_TPU_PALLAS_MSM_LOOP", "1") == "1"
USE_PALLAS_FOLD = os.environ.get("COMETBFT_TPU_PALLAS_FOLD", "1") == "1"
USE_PALLAS_MSM_MAJOR = os.environ.get(
    "COMETBFT_TPU_PALLAS_MSM_MAJOR", "1") == "1"


def _require_straus() -> None:
    """COMETBFT_TPU_MSM_ENGINE: straus, or auto (which the JAX package's
    cost model resolves to Straus at every ed25519 width).  The bucket
    (Pippenger) engine of ops/msm.py is not ported yet, so asking for it
    raises rather than running Straus in its place."""
    engine = os.environ.get("COMETBFT_TPU_MSM_ENGINE", "auto")
    if engine == "bucket":
        raise NotImplementedError(
            "COMETBFT_TPU_MSM_ENGINE=bucket: the bucket MSM engine "
            "(ops/msm.py) is not ported to cometbft_tpu_torch; use straus "
            "or auto")


def _npart(w: int) -> int:
    """Partial-accumulator count: halve the width until <= NPART_MAX."""
    while w > NPART_MAX:
        if w % 2:
            raise ValueError(f"width {w} does not halve to <= {NPART_MAX} "
                             "partials")
        w //= 2
    return w


def _select17(table, mag):
    """(17, 4, 20, W) table, (W,) int32 magnitudes -> (4, 20, W); a
    magnitude outside 1..16 selects row 0."""
    sel = table[0]
    for k in range(1, 17):
        sel = torch.where((mag == k)[None, None], table[k], sel)
    return sel


def _cond_neg_point(p, neg):
    """Negate extended points where neg: X -> -X, T -> -T (plain
    arithmetic negation of the redundant signed limbs)."""
    n = neg[None]
    return torch.stack([torch.where(n, -p[_X], p[_X]), p[_Y], p[_Z],
                        torch.where(n, -p[_T], p[_T])], dim=0)


def _msm_scan(tab, mags, negs):
    """The MSM value as one (4, 20, 1) point, through the engine the
    flags choose: window-major (K3, or K5 when WIN_GROUP > 1), else
    window-loop (K6), else a window scan of torch point ops whose window
    contributions come from select-tree (K7) or, with all three flags
    off, from a plain torch select and tree.

    tab: (17, 4, 20, W); mags: (nwin, W) int32 magnitudes, MSB-first;
    negs: (nwin, W) bool signs."""
    w = tab.shape[-1]
    _require_straus()
    if USE_PALLAS_MSM_MAJOR:
        return _tree_reduce(cuda_msm.msm_window_major(tab, mags, negs), 1)
    if USE_PALLAS_MSM_LOOP:
        return _tree_reduce(cuda_msm.msm_window_loop(tab, mags, negs), 1)
    if USE_PALLAS_TREE:
        blk, out_l, nblk = cuda_msm.loop_geometry(w, None)
        npart = nblk * out_l

        def window_contrib(mag, neg):
            return cuda_msm.select_tree(tab, mag, neg, blk)
    else:
        npart = _npart(w)

        def window_contrib(mag, neg):
            contrib = _cond_neg_point(_select17(tab, mag), neg)
            return _tree_reduce(contrib, npart)

    acc = identity_point((npart,), tab.device)
    for j in range(mags.shape[0]):
        acc = straus_step(acc, window_contrib(mags[j], negs[j]))
    return _tree_reduce(acc, 1)


def _msm(enc_words, mags, negs):
    """Straus MSM sum_i e_i * (-P_i) over one batch side: decompress
    (K1), 17-row tables (K2), the scan.  Returns ((4, 20, 1) point,
    all-decompressed-ok)."""
    tab, ok = build_a_tables(enc_words)
    return _msm_scan(tab, mags, negs), ok


def _loop_partials(tab, mags, negs):
    """One MSM side's partials for the fused epilogue: window-major
    (K3 / K5) or window-loop (K6), or None when both are off.  Unlike the
    JAX package, which drops to XLA at a width with no legal block, the
    port's kernels take any width, so None means only that the flags
    ask for the non-fused scan.  The JAX package's fused branch does not
    consult the MSM engine; the port refuses the bucket engine here too,
    since it has none to run."""
    if not (USE_PALLAS_MSM_LOOP or USE_PALLAS_MSM_MAJOR):
        return None
    _require_straus()
    if USE_PALLAS_MSM_MAJOR:
        return cuda_msm.msm_window_major(tab, mags, negs)
    return cuda_msm.msm_window_loop(tab, mags, negs)


# ---------------------------------------------------------------------------
# random-linear-combination batch verification
# ---------------------------------------------------------------------------
#
#   [8] * ( sum_i z_i*s_i * B  -  sum_i (z_i*h_i)*A_i  -  sum_i z_i*R_i ) == 0
#
# with z_i random 128-bit scalars; the host (crypto/ed25519.pack_rlc)
# aggregates repeated pubkeys, puts the fixed-base term in A slot 0 as
# (-B, c) and recodes every scalar into signed 5-bit digits.  The device
# runs two Straus MSMs over negated tables and one fold.

def rlc_verify_kernel(a_words, r_words, a_mag, a_neg, r_mag, r_neg):
    """Whole-batch RLC verify: one 0-dim bool verdict.

    a_words: (8, K) distinct pubkey encodings (slot 0 = -B, pads = B);
    r_words: (8, N) R encodings; a_mag/a_neg: (52, K), r_mag/r_neg:
    (26, N) signed-window digits, MSB-first."""
    tab_a, ok_a = build_a_tables(a_words)
    return rlc_verify_kernel_cached_a(tab_a, ok_a, r_words,
                                      a_mag, a_neg, r_mag, r_neg)


def rlc_verify_kernel_cached_a(a_tab, a_ok, r_words,
                               a_mag, a_neg, r_mag, r_neg):
    """RLC verify with a PRE-BUILT A-side table (ATableCache): skips the
    A decompression and table build.  Fused: both sides' partials, then
    K4.  Non-fused (USE_PALLAS_FOLD off, or no partials): each side's
    _msm_scan, then the add, 3 cofactor doublings and the identity test
    in torch point ops."""
    tab_r, ok_r = build_a_tables(r_words)
    if USE_PALLAS_FOLD:
        pa = _loop_partials(a_tab, a_mag, a_neg)
        pr = _loop_partials(tab_r, r_mag, r_neg)
        if pa is not None and pr is not None:
            return a_ok & ok_r & cuda_msm.fold_verify(pa, pr)
    total = point_add(_msm_scan(a_tab, a_mag, a_neg),
                      _msm_scan(tab_r, r_mag, r_neg))
    for _ in range(3):               # cofactor 8
        total = point_double(total, with_t=False)
    return a_ok & ok_r & point_is_identity(total)[0]


# ---------------------------------------------------------------------------
# per-signature verification (reject localization)
# ---------------------------------------------------------------------------

WINDOW = 4

# static base-point table k*B (k=0..15) in cached form, (16, 4, 20)
_BTAB_NP = np.zeros((16, 4, fe.NLIMBS), dtype=np.int32)
for _k, _pt_ref in enumerate(ref.base_window_table(WINDOW)):
    _x, _y, _z, _t = _pt_ref
    _zi = pow(_z, fe.P - 2, fe.P)
    _x, _y = _x * _zi % fe.P, _y * _zi % fe.P
    _BTAB_NP[_k, 0] = fe.int_to_limbs((_y + _x) % fe.P)
    _BTAB_NP[_k, 1] = fe.int_to_limbs((_y - _x) % fe.P)
    _BTAB_NP[_k, 2] = fe.int_to_limbs(fe.D2_INT * _x * _y % fe.P)
    _BTAB_NP[_k, 3] = fe.int_to_limbs(2)


def _nibbles(s: torch.Tensor) -> torch.Tensor:
    """(16, N) radix-2**16 limbs -> (64, N) nibbles, LSB first."""
    shifts = torch.arange(0, 16, 4, device=s.device).reshape(1, 4, 1)
    return ((s.unsqueeze(1) >> shifts) & 0xF).reshape(-1, s.shape[-1])


def _select(table, nib):
    """table (16, 4, 20, N) or (16, 4, 20, 1), nib (N,) -> (4, 20, N)."""
    n = nib.shape[0]
    table = table.expand(table.shape[:3] + (n,))
    idx = nib.long().reshape(1, 1, 1, n).expand((1,) + table.shape[1:])
    return torch.gather(table, 0, idx)[0]


def verify_kernel(a_words, r_words, s_limbs, h_limbs):
    """Batched per-signature ZIP-215 verify.

    a_words, r_words: (8, N) int32 bit patterns of pubkey / R encodings;
    s_limbs, h_limbs: (16, N) int32 radix-2**16 limbs of s and
    h = SHA512(R||A||M) mod L.  Returns (N,) bool verdicts.
    Decompression runs on K1; the 4-bit Straus chain is plain torch
    (it is plain XLA in the JAX package, and it runs only on a reject)."""
    n = a_words.shape[-1]
    pts, oks = decompress(torch.cat([a_words, r_words], dim=-1))
    a_pt, r_pt = pts[..., :n], pts[..., n:]
    ok_a, ok_r = oks[:n], oks[n:]

    rows = [identity_point((n,), a_pt.device), point_neg(a_pt)]
    neg_a_cached = to_cached(rows[1])
    for _ in range(14):
        rows.append(add_cached(rows[-1], neg_a_cached))
    neg_a_tab = torch.stack([to_cached(r) for r in rows], dim=0)
    btab = devmod.constant(_BTAB_NP, a_pt.device, torch.int32)[..., None]
    s_nib = _nibbles(s_limbs)
    h_nib = _nibbles(h_limbs)

    acc = identity_point((n,), a_pt.device)
    for i in range(s_nib.shape[0] - 1, -1, -1):
        for _ in range(3):
            acc = point_double(acc, with_t=False)
        acc = point_double(acc, with_t=True)
        acc = add_cached(acc, _select(btab, s_nib[i]))
        acc = add_cached(acc, _select(neg_a_tab, h_nib[i]))
    acc = add_cached(acc, to_cached(point_neg(r_pt)))
    for _ in range(3):               # cofactor 8
        acc = point_double(acc, with_t=False)
    return ok_a & ok_r & point_is_identity(acc)


# ---------------------------------------------------------------------------
# device-side hash-to-scalar
# ---------------------------------------------------------------------------
#
# The device-hash programs take padded SHA-512 blocks of R||A||M instead
# of host-computed h: SHA-512 runs on K9 (ops/sha2.py), the reduction
# mod L, the z*h products, the per-key aggregation and the A-side
# signed-digit recode are torch ops on the same device.  Filler lanes
# carry z = 0, group 0 and n_blocks 0, so their zh vanishes whatever
# their (zeroed) blocks hash to.  There is no A-table cache on this
# path, as in the JAX package.
#
# Signed-digit recode without a sequential carry sweep: the signed
# 5-bit digits of x are the base-32 digits of x + BIAS minus 16, where
# BIAS = sum_j 16*32**j.

_NDIG_A = 52                       # 256-bit scalars, 5-bit windows
_W5_BIAS_LIMBS = lb.int_to_limbs(
    sum(16 << (5 * j) for j in range(_NDIG_A)), 17)


def _h_scalars(blocks_hi, blocks_lo, n_blocks):
    """Padded message blocks -> (N, 16) int64 limbs of SHA512(msg) mod L."""
    sh, sl = sha2.sha512_blocks(blocks_hi, blocks_lo, n_blocks)
    return sc.barrett_reduce_wide(sc.digest512_to_wide_limbs(sh, sl))


def _zh_mod_l(z_limbs, h_limbs):
    """(N, 8) z limbs x (N, 16) h limbs -> (N, 16) z*h mod L.  The
    384-bit product is < 2**381, inside Barrett's 512-bit domain."""
    prod = lb.mul(z_limbs, h_limbs)                       # (N, 24)
    pad = prod.new_zeros(prod.shape[:-1] + (sc.WIDE - prod.shape[-1],))
    return sc.barrett_reduce_wide(torch.cat([prod, pad], dim=-1))


def _segment_sum_mod_l(zh, group_ids, k):
    """Per-A-slot sum of zh rows mod L: (N, 16) x (N,) -> (k, 16).

    The JAX package scatters in radix 2**8 because 16-bit limbs overflow
    uint32 past N = 65,536; here the scatter-add runs on int64 columns,
    which hold N * (2**16 - 1) for any N below 2**47.  One carry sweep
    over 32 limbs then normalizes the sum (< N * L) for Barrett."""
    acc = zh.new_zeros((k, zh.shape[-1]))
    acc.index_add_(0, group_ids.long(), zh)
    wide = torch.cat([acc, acc.new_zeros((k, sc.WIDE - acc.shape[-1]))],
                     dim=-1)
    limbs, _ = lb.carry_prop(wide)
    return sc.barrett_reduce_wide(limbs)


def _add_mod_l(a, b):
    """(..., 16) + (..., 16) mod L for inputs already < L."""
    s, _ = lb.carry_prop(a + b)                           # sum < 2L < 2**254
    return lb.cond_sub(s, lb.const(sc.L_LIMBS, s))


def _recode_w5_device(scalars):
    """(K, 16) limbs (< L) -> ((52, K) int32, (52, K) bool) signed-window
    digit magnitudes and signs, MSB-first: bit-identical to the host
    crypto/ed25519._recode_w5."""
    pad = scalars.new_zeros(scalars.shape[:-1] + (1,))
    xb, _ = lb.carry_prop(torch.cat([scalars, pad], dim=-1)
                          + lb.const(_W5_BIAS_LIMBS, scalars))   # (K, 17)
    return msm_engine.recode_biased_digits(xb, 5, _NDIG_A)


def rlc_verify_hash_kernel(a_words, r_words, base_limbs, z_limbs,
                           group_ids, blocks_hi, blocks_lo, n_blocks,
                           r_mag, r_neg):
    """Whole-batch RLC verify with device-side hash-to-scalar: one 0-dim
    bool verdict.

    a_words: (8, K) distinct-pubkey encodings (slot 0 = -B, pads = B);
    r_words: (8, N) R encodings (int32 bit patterns);
    base_limbs: (K, 16) host scalar per A slot (slot 0 = c = sum z*s
                mod L, others zero); z_limbs: (N, 8) 128-bit z_i;
    group_ids: (N,) A-slot index per signature (fillers -> 0, where
               z = 0 keeps them inert);
    blocks_hi/lo: (N, B, 16) int32 padded SHA-512 blocks of R||A||M;
    n_blocks: (N,) int32; r_mag/r_neg: (26, N) z_i window digits,
    MSB-first.  The verdict comes from rlc_verify_kernel (K1-K4)."""
    h = _h_scalars(blocks_hi, blocks_lo, n_blocks)        # (N, 16)
    zh = _zh_mod_l(z_limbs.long(), h)                     # (N, 16)
    seg = _segment_sum_mod_l(zh, group_ids, a_words.shape[-1])
    a_mag, a_neg = _recode_w5_device(_add_mod_l(base_limbs.long(), seg))
    return rlc_verify_kernel(a_words, r_words, a_mag, a_neg, r_mag, r_neg)


def verify_hash_kernel(a_words, r_words, s_limbs, blocks_hi, blocks_lo,
                       n_blocks):
    """Per-signature verify with device-side hashing: the reject
    localization of the device-hash path, so digests stay on the device
    when a batch fails and single verdicts are needed.  s_limbs: (16, N)
    int32; returns (N,) bool verdicts from verify_kernel."""
    h = _h_scalars(blocks_hi, blocks_lo, n_blocks)        # (N, 16)
    return verify_kernel(a_words, r_words, s_limbs,
                         h.T.to(torch.int32).contiguous())


# ---------------------------------------------------------------------------
# shape buckets
# ---------------------------------------------------------------------------

_SMALL_WIDTHS = (8, 16, 32, 64, 96, 128, 160, 192)
_BASE_WIDTHS = (128, 160, 192)


def pad_width(n: int) -> int:
    """Bucketed batch width for an MSM side: small widths verbatim,
    larger ones base*2^L with base in a 3-element grid (pad waste
    <= 25%)."""
    if n <= _SMALL_WIDTHS[-1]:
        for w in _SMALL_WIDTHS:
            if n <= w:
                return w
    lvl = 1
    while True:
        for base in _BASE_WIDTHS:
            if n <= base << lvl:
                return base << lvl
        lvl += 1


BATCH_BUCKETS = (16, 64, 256, 1024, 4096, 16384)


def bucket_size(n: int) -> int:
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    return ((n + BATCH_BUCKETS[-1] - 1) // BATCH_BUCKETS[-1]) \
        * BATCH_BUCKETS[-1]
