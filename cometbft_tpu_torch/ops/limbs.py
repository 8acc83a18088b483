"""Multi-limb big-integer arithmetic in radix 2**16 on torch tensors — the
port's counterpart of `cometbft_tpu.ops.limbs`.

An n-limb number is a (..., n) tensor of values in [0, 2**16),
little-endian limb order, the limb axis LAST, as in the JAX package.
The JAX package holds limbs in uint32; torch has no unsigned 32-bit
arithmetic to rely on, so the port holds them in int64: a 16x16-bit
product reaches 2**32, and every product and column sum below fits in
int64 with room to spare.  Results equal the JAX package's limb for
limb (mul_raw keeps its (lo, hi) split of each partial product).
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as devmod

MASK16 = 0xFFFF
LIMB_BITS = 16
LIMB_RADIX = 1 << LIMB_BITS


# ---------------------------------------------------------------------------
# host <-> limb conversion (numpy)
# ---------------------------------------------------------------------------

def int_to_limbs(x: int, n: int) -> np.ndarray:
    """Python int -> n uint32 limbs (radix 2**16, little-endian)."""
    if x < 0:
        raise ValueError("negative")
    out = np.zeros(n, dtype=np.uint32)
    for i in range(n):
        out[i] = x & 0xFFFF
        x >>= 16
    if x:
        raise ValueError("value does not fit in %d limbs" % n)
    return out


def limbs_to_int(limbs) -> int:
    """Limb array or tensor -> Python int (accepts un-normalized limbs)."""
    arr = np.asarray(limbs).astype(np.int64)
    return sum(int(v) << (16 * i) for i, v in enumerate(arr))


def const(limbs: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Host limbs -> int64 tensor on like's device, copied there once."""
    return devmod.constant(limbs, like.device, torch.int64)


# ---------------------------------------------------------------------------
# tensor ops (int64, limb axis last)
# ---------------------------------------------------------------------------

def carry_prop(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full carry propagation of non-negative limbs.

    Returns (normalized limbs in [0, 2**16), carry out of the top
    limb).  Sequential over the (small, static) limb axis, vectorized
    over the batch."""
    out = []
    carry = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    for i in range(x.shape[-1]):
        v = x[..., i] + carry
        out.append(v & MASK16)
        carry = v >> LIMB_BITS
    return torch.stack(out, dim=-1), carry


def _antidiag_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum p[..., i, j] over equal i+j -> (..., na+nb-1): pad each row i
    to width nb+na, flatten, drop the last na elements and reshape to
    rows of width nb+na-1, so that row i lies shifted right by i."""
    na, nb = p.shape[-2], p.shape[-1]
    w = na + nb
    skew = torch.cat([p, p.new_zeros(p.shape[:-1] + (na,))], dim=-1)
    skew = skew.reshape(p.shape[:-2] + (na * w,))[..., :na * (w - 1)]
    return skew.reshape(p.shape[:-2] + (na, w - 1)).sum(dim=-2)


def mul_raw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of an na-limb and an nb-limb number: na+nb
    un-normalized limbs, each partial product split into its (lo, hi)
    16-bit halves as in the JAX package.  Inputs normalized."""
    p = a[..., :, None] * b[..., None, :]          # (..., na, nb) < 2**32
    t_lo = _antidiag_sum(p & MASK16)
    t_hi = _antidiag_sum(p >> LIMB_BITS)
    zero = torch.zeros_like(t_lo[..., :1])
    return torch.cat([t_lo, zero], dim=-1) + torch.cat([zero, t_hi], dim=-1)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Normalized product: na+nb limbs in [0, 2**16)."""
    out, _ = carry_prop(mul_raw(a, b))
    # the carry out of the top limb of an exact-width product is zero
    return out


def ge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b for normalized equal-width limbs (b may broadcast): bool."""
    shape = torch.broadcast_shapes(a.shape, b.shape)[:-1]
    gt = torch.zeros(shape, dtype=torch.bool, device=a.device)
    eq = torch.ones(shape, dtype=torch.bool, device=a.device)
    for i in range(a.shape[-1] - 1, -1, -1):
        gt = gt | (eq & (a[..., i] > b[..., i]))
        eq = eq & (a[..., i] == b[..., i])
    return gt | eq


def sub_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod 2**(16 n) for normalized limbs: a - b when a >= b
    (borrow chain)."""
    out = []
    borrow = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    for i in range(a.shape[-1]):
        v = a[..., i] + LIMB_RADIX - b[..., i] - borrow
        out.append(v & MASK16)
        borrow = 1 - (v >> LIMB_BITS)
    return torch.stack(out, dim=-1)


def cond_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b if a >= b else a (branch-free select)."""
    return torch.where(ge(a, b)[..., None], sub_exact(a, b), a)


def words32_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """(..., n) 32-bit words (int64 values in [0, 2**32)) -> (..., 2n)
    radix-2**16 limbs."""
    lo = words & MASK16
    hi = words >> LIMB_BITS
    return torch.stack([lo, hi], dim=-1).reshape(
        words.shape[:-1] + (2 * words.shape[-1],))
