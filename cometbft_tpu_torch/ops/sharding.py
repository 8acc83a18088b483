"""Multi-device signature verification: the batch is the axis that
splits over devices — the port's counterpart of
`cometbft_tpu.ops.sharding`.

The per-signature program verifies each lane on its own, so it splits
into contiguous lane chunks, one program per device, with one gather
of the verdicts at the end.  The RLC whole-batch program stays one
program per dispatch; with several devices a window splits across them
instead (crypto/mesh.split_rlc_verify).

Where the JAX package builds a `jax.sharding.Mesh` and one jitted
program with shardings, the port takes a device list: each shard's
tensors move to its device and its program runs there, launched under
that device's context by the kernel wrappers.  A list may name one
card more than once; its shards then run in turn on that card.
"""

from __future__ import annotations

import math
import os

import torch

from . import ed25519 as dev


def device_count() -> int:
    """The number of CUDA devices (0 without a card)."""
    return torch.cuda.device_count()


def mesh_device_list(k: int | None = None):
    """Devices the dispatch layer splits windows over (crypto/mesh), or
    None for the single-device path.

    k > 1 asks for that many devices (clamped to what exists); k == 1
    forces single-device; k None/0 defers to COMETBFT_TPU_MESH_DEVICES,
    which itself defaults to single-device: multi-device dispatch is
    opt-in.  0 through the variable means every local device."""
    if k is None or k == 0:
        raw = os.environ.get("COMETBFT_TPU_MESH_DEVICES")
        if raw is None:
            return None
        k = int(raw)
    n = device_count()
    if k <= 0:
        k = n
    k = min(k, n)
    return [torch.device("cuda", i) for i in range(k)] if k > 1 else None


def auto_bucket(n: int, n_devices: int | None = None) -> int:
    """Batch bucket for n signatures that the devices divide evenly:
    dev.bucket_size rounded up to a multiple of the device count, so a
    split never sees a ragged shard."""
    b = dev.bucket_size(n)
    nd = n_devices if n_devices is not None else device_count()
    if nd > 1 and b % nd:
        b = math.lcm(b, nd)
    return b


def localization_width(n: int, n_devices: int | None = None) -> int:
    """Lanes the per-signature localization packs n signatures into:
    auto_bucket where it splits over several devices (None: every local
    card), whose evenly divided shards the split needs; n on one device,
    where K1 and K14 launch over the live lanes (a hand kernel compiles
    once for every width, so the bucket's filler lanes would only add
    work)."""
    nd = n_devices if n_devices is not None else device_count()
    return auto_bucket(n, nd) if nd > 1 else n


def verify_batch_sharded(a_words, r_words, s_limbs, h_limbs, devices=None):
    """Per-signature verdicts of pack_batch's arrays with the batch axis
    split into contiguous chunks over `devices` (None: every local
    card), each chunk's program launched before any verdict is read;
    the (B,) bool verdicts are gathered onto devices[0].  With fewer
    than two devices, or a width the device count does not divide, it
    is the single-device program (on devices[0], else the current
    card)."""
    from .. import convert

    if devices is None:
        devices = [torch.device("cuda", i) for i in range(device_count())]
    n = len(devices)
    width = a_words.shape[-1]
    if n < 2 or width % n:
        return dev.verify_kernel(*convert.batch_from_numpy(
            a_words, r_words, s_limbs, h_limbs,
            devices[0] if devices else "cuda"))
    step = width // n
    outs = [dev.verify_kernel(*convert.batch_from_numpy(
                *(x[:, i * step:(i + 1) * step]
                  for x in (a_words, r_words, s_limbs, h_limbs)), d))
            for i, d in enumerate(devices)]
    return torch.cat([o.to(devices[0]) for o in outs])
