"""The parts of `cometbft_tpu.ops.msm` that the port's paths run: the
biased signed-window digit extraction of the device-hash path, the odd
signed-digit (Joye-Tunstall) recode and the shared-table multi-product
of the secp256k1 MSM program.  The bucket (Pippenger) engine of that
module, its engine choice and its calibration are not ported: they lie
on no path the port has (ops/ed25519._require_straus)."""

from __future__ import annotations

import numpy as np
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


def recode_jt(ks, width: int, ndig: int):
    """Odd signed-digit recode (Joye-Tunstall), closed form, host side.

    For ODD k the width-w odd signed digits are
    d_i = 2 * ((k >> (i*w + 1)) mod 2**w) + 1 - 2**w: every digit odd in
    [-(2**w - 1), 2**w - 1], and for 0 < k < 2**(ndig*w + 1)
    k = sum_i d_i * 2**(i*w) + 2**(ndig*w), the fixed remainder being a
    known correction point the kernel adds once.  No digit selects the
    identity.

    Returns (rows, negs): rows (ndig, N) int32 in [0, 2**(w-1)) indexing
    the odd multiple (2*row + 1) * 2**(i*w), negs (ndig, N) bool, window
    index i ascending (LSB first)."""
    n = len(ks)
    nbytes = (ndig * width + 7) // 8 + 3
    buf = np.zeros((n, nbytes), np.uint8)
    for i, k in enumerate(ks):
        k = int(k)
        assert k & 1 and 0 < k < (1 << (ndig * width + 1)), \
            "recode_jt needs odd 0 < k < 2^(ndig*w+1)"
        buf[i] = np.frombuffer(k.to_bytes(nbytes, "little"), np.uint8)
    b = buf.astype(np.uint32)
    mask = np.uint32((1 << width) - 1)
    rows = np.empty((ndig, n), np.int32)
    negs = np.empty((ndig, n), bool)
    for i in range(ndig):
        p = i * width + 1
        byi, sh = p >> 3, p & 7
        word = b[:, byi] | (b[:, byi + 1] << 8) | (b[:, byi + 2] << 16)
        d = (2 * ((word >> sh) & mask).astype(np.int64)
             + 1 - (1 << width))
        neg = d < 0
        mag = np.where(neg, -d, d)                 # odd, >= 1
        rows[i] = ((mag - 1) >> 1).astype(np.int32)
        negs[i] = neg
    return rows, negs


def jt_digit_value(rows: np.ndarray, negs: np.ndarray, width: int) -> int:
    """sum_i d_i 2**(i*w) of one recode_jt column (add 2**(ndig*w) for
    k): the test oracle of the closed form."""
    total = 0
    for i in range(rows.shape[0]):
        d = int(2 * rows[i] + 1)
        total += (-d if negs[i] else d) << (i * width)
    return total


def multiprod_shared_tables(acc, sides):
    """N independent products against shared precomputed window tables,
    with no in-loop doubling.

    acc seeds the accumulator (the blinding point S at the lane width).
    sides is a sequence of (tables, rows, negs, gather, add_entry):
    tables stacks the per-window tables on axis 0, rows / negs are
    (nwin, N) recode_jt digits, gather(tab_j, rows_j) widens window j's
    table to one entry per lane and add_entry(acc, entry, neg) makes the
    (incomplete, blinding-protected) add.  The caller adds the per-side
    2**(ndig*w) corrections and subtracts S (ops/secp256k1's plain
    msm_verify_kernel)."""
    for tables, rows, negs, gather, add_entry in sides:
        for tab_j, row, neg in zip(tables, rows, negs):
            acc = add_entry(acc, gather(tab_j, row), neg)
    return acc
