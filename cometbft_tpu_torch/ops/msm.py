"""Signed-window digit extraction — the one function of
`cometbft_tpu.ops.msm` that the port's device-hash path needs.  The
bucket (Pippenger) engine of that module is not ported."""

from __future__ import annotations

import torch


def recode_biased_digits(xb: torch.Tensor, width: int, ndig: int):
    """(..., L) 16-bit limbs (int64) of x + BIAS -> ((ndig, ...) int32,
    (ndig, ...) bool) signed-window digit magnitudes and signs,
    MSB-first, BIAS = sum_j 2**(width-1) * 2**(width*j).  Static bit
    extraction only; the caller performs the bias addition (it owns the
    scalar-limb carry discipline).  width <= 16."""
    mask = (1 << width) - 1
    half = 1 << (width - 1)
    nl = xb.shape[-1]
    mags, negs = [], []
    for j in range(ndig - 1, -1, -1):              # MSB first
        p = width * j
        li, sh = p >> 4, p & 15
        word = xb[..., li]
        if li + 1 < nl:
            word = word | (xb[..., li + 1] << 16)
        d = ((word >> sh) & mask).to(torch.int32) - half
        negs.append(d < 0)
        mags.append(d.abs())
    return torch.stack(mags, dim=0), torch.stack(negs, dim=0)
