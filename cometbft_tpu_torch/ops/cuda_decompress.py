"""Kernel K1: ZIP-215 point decompression, and its plain torch version.

Replaces the Pallas TPU kernel `cometbft_tpu/ops/pallas_decompress.py::
decompress` (`_decompress_kernel`, pallas_call at :143).  On the TPU the
kernel exists to keep the ~270-product square-root chain in VMEM instead
of paying XLA's per-op dispatch; here one CUDA thread decodes one
encoding with the whole chain in registers (ops/csrc/ed25519_kernels.cu
`decompress_kernel`).

What bounds it on the H100: integer multiply-adds — about 265 field
squarings/products of 210/400 IMADs per lane, against 32 bytes in and
324 bytes out per lane.  The design does nothing clever beyond one lane
per thread and coalesced limbs-first loads and stores.
"""

from __future__ import annotations

import torch

from . import device as devmod
from . import fe


def decompress_plain(enc_words: torch.Tensor):
    """(8, W) int32 bit patterns -> ((4, 20, W) extended point, (W,) ok),
    the XLA twin of the JAX package (ops/ed25519.decompress) in torch."""
    y = fe.words32_to_limbs(enc_words)
    sign = (enc_words[7] >> 31) & 1
    one = fe.const(fe.ONE_LIMBS, y)
    y2 = fe.sqr(y)
    u = fe.sub(y2, one)
    v = fe.add(fe.mul(y2, fe.const(fe.D_LIMBS, y)), one)
    x, ok = fe.sqrt_ratio(u, v)
    xf = fe.freeze(x)
    x_zero = torch.all(xf == 0, dim=0)
    ok = ok & ~(x_zero & (sign == 1))
    flip = (xf[0] & 1) != sign
    x = torch.where(flip[None], fe.neg(x), x)
    t = fe.mul(x, y)
    return torch.stack([x, y, one.expand_as(y), t], dim=0), ok


def decompress(enc_words: torch.Tensor):
    """(8, W) int32 bit patterns of LE uint32 words -> ((4, 20, W) int32
    extended point, (W,) bool ok).  CPU tensor: the plain version; CUDA
    tensor: kernel K1."""
    if not enc_words.is_cuda:
        return decompress_plain(enc_words)
    from . import _build

    devmod.require(enc_words, "decompress words", torch.int32, (8, None))
    words = enc_words.contiguous()
    w = words.shape[-1]
    pt = torch.empty((4, fe.NLIMBS, w), dtype=torch.int32, device=words.device)
    ok = torch.empty((w,), dtype=torch.int32, device=words.device)
    lib = _build.load("ed25519_kernels")
    with torch.cuda.device(words.device):
        rc = lib.ed25519_decompress(devmod.ptr(words), w, devmod.ptr(pt),
                                    devmod.ptr(ok), devmod.stream(words))
    devmod.check_launch(rc, "ed25519_decompress")
    decompress.launches += 1
    return pt, ok != 0


decompress.launches = 0
