"""Arithmetic mod the Ed25519 group order L in radix-2**16 limbs — the
port's counterpart of `cometbft_tpu.ops.scalar25519`.

The device-hash path reduces h = SHA512(R || A || M) mod L with a Barrett
division in limbs (ops/limbs.py: int64, limb axis last), so no digest
crosses back to the host.
"""

from __future__ import annotations

import torch

from . import limbs as lb

L = (1 << 252) + 27742317777372353535851937790883648493
NLIMBS = 16          # L fits in 253 bits -> 16 limbs
WIDE = 32            # 512-bit inputs

L_LIMBS = lb.int_to_limbs(L, NLIMBS)
# Barrett constant: mu = floor(2**512 / L), 260 bits -> 17 limbs
MU = (1 << 512) // L
MU_LIMBS = lb.int_to_limbs(MU, 17)
L_LIMBS_18 = lb.int_to_limbs(L, 18)


def barrett_reduce_wide(x: torch.Tensor) -> torch.Tensor:
    """Reduce a 512-bit value (32 normalized limbs) mod L -> 16 limbs.

    Classic Barrett with base b = 2**16, k = 16:
      q = floor( floor(x / b**(k-1)) * mu / b**(k+1) );  r = x - q*L
    with r < 3L, fixed by two conditional subtractions."""
    q1 = x[..., 15:]                                  # floor(x / b^15)
    q3 = lb.mul(q1, lb.const(MU_LIMBS, x))[..., 17:]  # 17 limbs
    # r = x - q3*L computed mod b^18 (r < 3L < b^18 makes it exact)
    l18 = lb.const(L_LIMBS_18, x)
    ql = lb.mul(q3[..., :18], l18)[..., :18]
    diff = lb.sub_exact(x[..., :18], ql)
    diff = lb.cond_sub(diff, l18)
    diff = lb.cond_sub(diff, l18)
    return diff[..., :NLIMBS]


def _bswap32(w: torch.Tensor) -> torch.Tensor:
    return (((w & 0xFF) << 24) | ((w & 0xFF00) << 8)
            | ((w >> 8) & 0xFF00) | (w >> 24))


def digest512_to_wide_limbs(hi: torch.Tensor, lo: torch.Tensor):
    """SHA-512 digest words (8 hi + 8 lo, big-endian word order, int32
    bit patterns or uint32 values) -> 32 int64 limbs.

    Ed25519 reads the 64-byte digest as a little-endian integer.  The
    digest bytes are word0..word7, each big-endian, so bswap32(hi0) is
    the least significant 32-bit group, then bswap32(lo0),
    bswap32(hi1), ..."""
    hs = _bswap32(hi.to(torch.int64) & 0xFFFFFFFF)
    ls = _bswap32(lo.to(torch.int64) & 0xFFFFFFFF)
    words = torch.stack([hs, ls], dim=-1).reshape(hi.shape[:-1] + (16,))
    return lb.words32_to_limbs(words)
