"""GF(2**255 - 19) arithmetic on torch tensors: the plain (reference)
field layer of the port, limb for limb the counterpart of
`cometbft_tpu.ops.fe`.

Representation (unchanged from the JAX package, so its bounds proof
carries over and every intermediate agrees limb for limb):
- field elements are (NLIMBS, ...batch) int32 tensors: 20 SIGNED limbs
  in radix 2**13, the limb axis first and the batch axis minor;
- 2**260 == 608 (mod p) folds the carry out of the top limb;
- op outputs have limbs in [-1220, 9800] ("weak" form); mul accepts
  |limb| <= 10300: 20 * 10300**2 = 2.12e9 < 2**31, so every column sum
  of a product — and every partial sum of one — fits in int32.

The CUDA kernels (ops/csrc/fe25519.cuh) run the same arithmetic per
thread; the functions here are what a CPU tensor runs and what the
kernels are held against on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as devmod

NLIMBS = 20
RADIX = 13
BASE = 1 << RADIX            # 8192
MASK = BASE - 1
WRAP = 19 << 5               # 608: 2**260 == 608 (mod p)
P = (1 << 255) - 19

_MAX_IN = 10300              # max |limb| mul accepts
assert NLIMBS * _MAX_IN * _MAX_IN < (1 << 31)


# ---------------------------------------------------------------------------
# host <-> limb conversion
# ---------------------------------------------------------------------------

def int_to_limbs(x: int) -> np.ndarray:
    """Python int -> 20 int32 limbs (radix 2**13, little-endian)."""
    x %= P
    out = np.zeros(NLIMBS, dtype=np.int32)
    for i in range(NLIMBS):
        out[i] = x & MASK
        x >>= RADIX
    assert x == 0
    return out


def limbs_to_int(limbs) -> int:
    """Accepts redundant/signed limbs; value mod p."""
    arr = np.asarray(limbs, dtype=np.int64)
    return sum(int(v) << (RADIX * i) for i, v in enumerate(arr)) % P


# curve constants
D_INT = (-121665 * pow(121666, P - 2, P)) % P
D2_INT = (2 * D_INT) % P
SQRT_M1_INT = pow(2, (P - 1) // 4, P)
D_LIMBS = int_to_limbs(D_INT)
D2_LIMBS = int_to_limbs(D2_INT)
SQRT_M1_LIMBS = int_to_limbs(SQRT_M1_INT)
ONE_LIMBS = int_to_limbs(1)

# canonical digits of p: [8173, 8191*18, 255]
_P_CANON = np.zeros(NLIMBS, dtype=np.int32)
_t = P
for _i in range(NLIMBS):
    _P_CANON[_i] = _t & MASK
    _t >>= RADIX

# 8p in 20 digits, every digit >= 2047: adding it makes any weak-form
# (limbs >= -1220) element nonnegative.
_PAD_8P = np.zeros(NLIMBS, dtype=np.int32)
_t = 8 * P
for _i in range(NLIMBS - 1):
    _PAD_8P[_i] = _t & MASK
    _t >>= RADIX
_PAD_8P[NLIMBS - 1] = _t
assert sum(int(v) << (RADIX * i) for i, v in enumerate(_PAD_8P)) == 8 * P
assert (_PAD_8P >= 2047).all()

def const(limbs: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """(20,) host constant -> (20, 1, ...) int32 tensor on like's device,
    broadcastable against like."""
    t = devmod.constant(limbs, like.device, torch.int32)
    return t.reshape((NLIMBS,) + (1,) * (like.dim() - 1))


# ---------------------------------------------------------------------------
# carries: whole-tensor shifts along the limb axis
# ---------------------------------------------------------------------------

def _carry_pass(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry step on 20 limbs.  Arithmetic >> keeps floor
    semantics for signed limbs, so lo = x & MASK = x - (hi << 13) is in
    [0, 2**13); the top limb's carry wraps through 2**260 == 608."""
    hi = x >> RADIX
    return (x & MASK) + torch.cat([hi[-1:] * WRAP, hi[:-1]], dim=0)


def norm_weak(x: torch.Tensor) -> torch.Tensor:
    """Two passes: |limb| < 2**27 input -> limbs in [-1220, 9800]."""
    return _carry_pass(_carry_pass(x))


def add(a, b):
    return _carry_pass(a + b)


def sub(a, b):
    return _carry_pass(a - b)


def neg(a):
    return _carry_pass(-a)


def _prod_tail(acc: torch.Tensor) -> torch.Tensor:
    """(39, ...) product columns -> weak-form (20, ...): carry pass in
    40-wide column space (column 39 catches the top carry), then the
    2**260 == 608 fold, then two carry passes (fe._prod_tail's bound
    proof: columns < 2**13 + 2.12e9/2**13 after the first pass, the fold
    stays under 608 * 267k < 2**31)."""
    zero = torch.zeros_like(acc[:1])
    acc = torch.cat([acc, zero], dim=0)
    hi = acc >> RADIX
    acc = (acc & MASK) + torch.cat([zero, hi[:-1]], dim=0)
    return norm_weak(acc[:NLIMBS] + WRAP * acc[NLIMBS:])


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product as ONE broadcast outer product plus a fixed
    column sum: row i of the (20, 20, ...) product shifts right by i
    (pad each row to 40, flatten, drop the last 20, view as (20, 39)),
    and the column sums are the 39 product columns.  Inputs:
    |limb| <= 10300."""
    batch = a.shape[1:]
    prod = a.unsqueeze(1) * b.unsqueeze(0)                 # (20, 20, ...)
    prod = torch.cat([prod, torch.zeros_like(prod)], dim=1)  # (20, 40, ...)
    skew = prod.reshape((2 * NLIMBS * NLIMBS,) + batch)[
        :NLIMBS * (2 * NLIMBS - 1)].reshape(
        (NLIMBS, 2 * NLIMBS - 1) + batch)
    return _prod_tail(skew.sum(dim=0, dtype=torch.int32))


def sqr(a: torch.Tensor) -> torch.Tensor:
    """a**2.  The JAX package's dedicated squaring sums the same column
    VALUES as mul(a, a) (cross terms once against doubled limbs), so the
    plain version shares mul's column sum; the CUDA kernels use the
    210-product form."""
    return mul(a, a)


def mul_word(a: torch.Tensor, w: int) -> torch.Tensor:
    """Multiply by a small nonneg constant: w * 10300 < 2**31."""
    return norm_weak(a * w)


def _sq_n(x: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        x = sqr(x)
    return x


def _pow_22501(z):
    """Shared prefix of the p-2 and (p-5)/8 chains: (z**(2**250-1), z**11)."""
    z2 = sqr(z)
    z9 = mul(_sq_n(z2, 2), z)
    z11 = mul(z9, z2)
    z2_5_0 = mul(sqr(z11), z9)
    z2_10_0 = mul(_sq_n(z2_5_0, 5), z2_5_0)
    z2_20_0 = mul(_sq_n(z2_10_0, 10), z2_10_0)
    z2_40_0 = mul(_sq_n(z2_20_0, 20), z2_20_0)
    z2_50_0 = mul(_sq_n(z2_40_0, 10), z2_10_0)
    z2_100_0 = mul(_sq_n(z2_50_0, 50), z2_50_0)
    z2_200_0 = mul(_sq_n(z2_100_0, 100), z2_100_0)
    z2_250_0 = mul(_sq_n(z2_200_0, 50), z2_50_0)
    return z2_250_0, z11


def pow_p58(z):
    """z**((p-5)/8)."""
    z2_250_0, _ = _pow_22501(z)
    return mul(_sq_n(z2_250_0, 2), z)


# ---------------------------------------------------------------------------
# canonicalization / predicates
# ---------------------------------------------------------------------------

def _ripple(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact sequential carry over the limbs: (digits in [0, 2**13),
    carry out of limb 19)."""
    c = torch.zeros_like(x[0])
    outs = []
    for i in range(NLIMBS):
        v = x[i] + c
        lo = v & MASK
        outs.append(lo)
        c = (v - lo) >> RADIX
    return torch.stack(outs, dim=0), c


def _seq_canonical_pass(x: torch.Tensor) -> torch.Tensor:
    """Exact sequential carry over nonneg limbs, then reduce the bits at
    and above 2**255 (limb 19 bits >= 8) through the 19-wrap."""
    x, c = _ripple(x)
    top = x[19] >> 8
    low19 = x[19] & 0xFF
    x0 = x[0] + top * 19 + c * WRAP
    return torch.cat([x0[None], x[1:19], low19[None]], dim=0)


def _cond_sub_p(x: torch.Tensor) -> torch.Tensor:
    """x - p if x >= p else x, for canonical digits (value < 2**255)."""
    p_l = _P_CANON.tolist()
    gt = torch.zeros_like(x[0], dtype=torch.bool)
    eq_ = torch.ones_like(x[0], dtype=torch.bool)
    for i in range(NLIMBS - 1, -1, -1):
        gt = gt | (eq_ & (x[i] > p_l[i]))
        eq_ = eq_ & (x[i] == p_l[i])
    diff, _ = _ripple(x - const(_P_CANON, x))
    return torch.where((gt | eq_)[None], diff, x)


def freeze(a: torch.Tensor) -> torch.Tensor:
    """Canonical representative in [0, p)."""
    x = norm_weak(a) + const(_PAD_8P, a)      # all limbs > 0
    for _ in range(3):
        x = _seq_canonical_pass(x)
    return _cond_sub_p(x)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(freeze(a) == 0, dim=0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return is_zero(sub(a, b))


def sqrt_ratio(u, v):
    """sqrt(u/v) per RFC 8032 decompression; returns (x, ok)."""
    v3 = mul(sqr(v), v)
    v7 = mul(sqr(v3), v)
    r = mul(mul(u, v3), pow_p58(mul(u, v7)))
    check = mul(v, sqr(r))
    correct = eq(check, u)
    flipped = eq(check, neg(u))
    x = torch.where(flipped[None], mul(r, const(SQRT_M1_LIMBS, r)), r)
    return x, correct | flipped


# ---------------------------------------------------------------------------
# packing: 8 little-endian 32-bit words -> limbs (words on axis 0)
# ---------------------------------------------------------------------------

def words32_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """(8, ...) int32 bit patterns of LE uint32 words -> (20, ...) int32
    limbs.  Bit 255 (the sign bit of point encodings) is EXCLUDED: limb
    19 holds bits 247..254 only."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    limbs = []
    for i in range(NLIMBS):
        bit = RADIX * i
        j, r = bit // 32, bit % 32
        v = w[j] >> r
        if r + RADIX > 32 and j + 1 < 8:
            v = v | (w[j + 1] << (32 - r))
        limbs.append(v & (MASK if i < NLIMBS - 1 else 0xFF))
    return torch.stack(limbs, dim=0).to(torch.int32)
