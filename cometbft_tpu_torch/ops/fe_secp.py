"""GF(p) arithmetic for secp256k1 on torch tensors, p = 2**256 - 2**32 -
977: the plain field layer of the port's secp256k1 kernels, limb for limb
the counterpart of `cometbft_tpu.ops.fe_secp`.

Representation (the JAX package's, kept so that its bounds proof carries
over and every intermediate a kernel emits equals the plain version limb
for limb):
- field elements are (NLIMBS, ...batch) int32 tensors: 22 SIGNED limbs in
  radix 2**12 (264 bits), the limb axis first and the batch axis minor;
- 2**264 == 2**40 + 250112 (mod p), which lands on the limbs as
  +256 at limb 0, +61 at limb 1 and +16 at limb 3 (_WRAP), so a top carry
  re-enters as three adds with small multipliers;
- op outputs are "weak" (limbs in about [-1800, 4900]); mul accepts
  |limb| <= 5000: 22 * 5000**2 = 5.5e8 < 2**31, so every product column,
  and every partial sum of one, fits in int32.

The CUDA kernels (K11-K13, ops/csrc/secp256k1_kernels.cu) compute the
same field elements in another radix (ops/csrc/fe_secp_n.cuh: eight
32-bit words); the functions here are what a CPU tensor runs and what
the kernels are held against on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import device as devmod

NLIMBS = 22
RADIX = 12
BASE = 1 << RADIX
MASK = BASE - 1
P = (1 << 256) - (1 << 32) - 977

# 2**264 mod p on the limbs: (multiplier, limb offset)
_WRAP = ((256, 0), (61, 1), (16, 3))
_MAX_IN = 5000               # max |limb| mul accepts
assert NLIMBS * _MAX_IN * _MAX_IN < (1 << 31)


def int_to_limbs(x: int) -> np.ndarray:
    """Python int -> 22 int32 limbs (radix 2**12, little-endian)."""
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


ONE_LIMBS = int_to_limbs(1)

# canonical digits of p
_P_CANON = np.zeros(NLIMBS, dtype=np.int32)
_t = P
for _i in range(NLIMBS):
    _P_CANON[_i] = _t & MASK
    _t >>= RADIX

# 17p, every digit but the top >= 3839: adding it makes any weak-form
# element nonnegative before freeze's exact sequential carries
_PAD_17P = np.zeros(NLIMBS, dtype=np.int32)
_t = 17 * P
for _i in range(NLIMBS - 1):
    _PAD_17P[_i] = _t & MASK
    _t >>= RADIX
_PAD_17P[NLIMBS - 1] = _t
assert sum(int(v) << (RADIX * i) for i, v in enumerate(_PAD_17P)) == 17 * P
assert (_PAD_17P[:-1] >= 3839).all()

# the wrap multipliers as a limb column: limb k of a carry out of the top
_WRAP_COL = np.zeros(NLIMBS, dtype=np.int32)
for _w, _off in _WRAP:
    _WRAP_COL[_off] = _w


_COLUMNS: dict = {}


def const(limbs: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """(22,) host constant -> (22, 1, ...) int32 tensor on like's device,
    broadcastable against like (kept per constant, device and rank: the
    carry passes ask for one on every call)."""
    key = (id(limbs), like.device, like.dim())
    t = _COLUMNS.get(key)
    if t is None:
        t = devmod.constant(limbs, like.device, torch.int32).reshape(
            (NLIMBS,) + (1,) * (like.dim() - 1))
        _COLUMNS[key] = t
    return t


def broadcast(limbs: np.ndarray, batch_shape, device) -> torch.Tensor:
    """(22,) host constant -> (22, *batch_shape) int32 tensor (a view)."""
    t = devmod.constant(limbs, device, torch.int32)
    return t.reshape((NLIMBS,) + (1,) * len(batch_shape)).expand(
        (NLIMBS,) + tuple(batch_shape))


# ---------------------------------------------------------------------------
# carries
# ---------------------------------------------------------------------------

def _shift_up(x: torch.Tensor) -> torch.Tensor:
    """Rows moved up one along the limb axis, a zero row entering."""
    return F.pad(x[:-1], (0, 0) * (x.dim() - 1) + (1, 0))


def _carry_pass(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry step; the top limb's carry wraps through
    2**264 as three small-multiplier adds.  Arithmetic >> keeps floor
    semantics, so x & MASK = x - (hi << 12) is in [0, 2**12)."""
    hi = x >> RADIX
    return (x & MASK) + _shift_up(hi) + const(_WRAP_COL, x) * hi[-1:]


def norm_weak(x: torch.Tensor) -> torch.Tensor:
    """Two passes: |limb| < 2**27 -> weak form."""
    return _carry_pass(_carry_pass(x))


def add(a, b):
    return _carry_pass(a + b)


def sub(a, b):
    return _carry_pass(a - b)


def neg(a):
    return _carry_pass(-a)


def _wrap_spread(cols: torch.Tensor, rows: int) -> torch.Tensor:
    """sum over _WRAP of w * cols placed at limb offset `off`, as a
    (rows, ...) tensor (cols has at most rows - 3 rows)."""
    out = torch.zeros((rows,) + tuple(cols.shape[1:]), dtype=cols.dtype,
                      device=cols.device)
    n = cols.shape[0]
    for w, off in _WRAP:
        out[off:off + n] += cols * w
    return out


def _prod_tail(acc: torch.Tensor) -> torch.Tensor:
    """(43, ...) product columns -> weak-form (22, ...), the JAX
    package's order: one carry pass in 44-column space; the 22 high
    columns re-enter through 2**264 at limbs 0, 1 and 3, the terms past
    limb 21 landing in a 5-limb spill; exactly one carry pass of the
    spill (a second would lose a -1 borrow, fe_secp.mul's note); the
    spill folded through 2**264 again; two weak carry passes."""
    zero = torch.zeros_like(acc[:1])
    acc = torch.cat([acc, zero], dim=0)                   # 44 columns
    hi = acc >> RADIX
    acc = (acc & MASK) + torch.cat([zero, hi[:-1]], dim=0)
    t = _wrap_spread(acc[NLIMBS:], NLIMBS + 5)            # 27 rows
    t[:NLIMBS] += acc[:NLIMBS]
    out, spill = t[:NLIMBS], t[NLIMBS:]
    s_hi = spill >> RADIX
    spill = (spill & MASK) + _shift_up(s_hi)
    return norm_weak(out + _wrap_spread(spill, NLIMBS))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product as ONE broadcast outer product plus a fixed
    column sum: row i of the (22, 22, ...) product shifts right by i
    (pad each row to 44, flatten, drop the last 22, view as (22, 43)),
    and the column sums are the 43 product columns.  Inputs:
    |limb| <= 5000."""
    prod = a.unsqueeze(1) * b.unsqueeze(0)                 # (22, 22, ...)
    batch = tuple(prod.shape[2:])
    prod = torch.cat([prod, torch.zeros_like(prod)], dim=1)  # (22, 44, ...)
    skew = prod.reshape((2 * NLIMBS * NLIMBS,) + batch)[
        :NLIMBS * (2 * NLIMBS - 1)].reshape(
        (NLIMBS, 2 * NLIMBS - 1) + batch)
    return _prod_tail(skew.sum(dim=0, dtype=torch.int32))


def sqr(a):
    return mul(a, a)


def mul_word(a, w: int):
    """|w| * 5000 must stay < 2**27 for the carry pass."""
    return norm_weak(a * w)


# exponent bits of p - 2, MSB first, for Fermat inversion
_PM2_BITS_MSB = [(P - 2) >> i & 1 for i in range(255, -1, -1)]


def inv(z: torch.Tensor) -> torch.Tensor:
    """z**(p-2) by square-and-multiply over the fixed exponent bits (the
    JAX scan's select of mul(acc, z) on a set bit)."""
    acc = broadcast(ONE_LIMBS, z.shape[1:], z.device)
    for bit in _PM2_BITS_MSB:
        acc = sqr(acc)
        if bit:
            acc = mul(acc, z)
    return acc


# ---------------------------------------------------------------------------
# canonicalization / predicates
# ---------------------------------------------------------------------------

def _ripple(x: torch.Tensor):
    """Exact sequential carry over the limbs: (digits in [0, 2**12),
    carry out of limb 21)."""
    c = torch.zeros_like(x[0])
    outs = []
    for i in range(NLIMBS):
        v = x[i] + c
        lo = v & MASK
        outs.append(lo)
        c = (v - lo) >> RADIX
    return torch.stack(outs, dim=0), c


def _seq_canonical_pass(x: torch.Tensor) -> torch.Tensor:
    """Exact sequential carry, then the bits at and above 2**256 (limb
    21 bits >= 4, and the carry out in units of 2**264) re-enter through
    2**256 == 2**32 + 977 (2**32 = 2**(2*12 + 8): limb 2, times 256)."""
    x, c = _ripple(x)
    extra = (x[21] >> 4) + c * (1 << 8)
    x0 = x[0] + extra * 977
    x2 = x[2] + extra * (1 << 8)
    return torch.cat([x0[None], x[1:2], x2[None], x[3:21],
                      (x[21] & 0xF)[None]], dim=0)


def _cond_sub_p(x: torch.Tensor) -> torch.Tensor:
    """x - p if x >= p else x, for canonical digits."""
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
    x = norm_weak(a) + const(_PAD_17P, a)
    for _ in range(3):
        x = _seq_canonical_pass(x)
    return _cond_sub_p(x)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(freeze(a) == 0, dim=0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return is_zero(sub(a, b))
