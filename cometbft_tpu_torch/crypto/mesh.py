"""Mesh-aware verify dispatch: the multi-device layer of the port — the
counterpart of `cometbft_tpu.crypto.mesh`.

Two shapes of parallelism, as in ops/sharding.py:

- the per-signature program is parallel along the batch axis: it splits
  over the devices with one gather of the verdicts
  (ops/sharding.verify_batch_sharded, buckets sized by
  ops/sharding.auto_bucket);
- the RLC whole-batch program stays one program per dispatch.  With
  several devices a multi-commit window splits across them:
  contiguous chunks, one RLC program per device (split_rlc_verify),
  each placed by moving its packed inputs to its device.  Chunk
  verdicts keep the per-chunk reject structure, so a reject localizes
  with the split per-signature program.

Multi-device dispatch is opt-in, through COMETBFT_TPU_MESH_DEVICES
(ops/sharding.mesh_device_list) or explicit device lists.  A device
list may name one card more than once: its chunks then run in turn on
that card.
"""

from __future__ import annotations

import os

# one RLC program per device only pays once each device's chunk
# amortizes its own dispatch and pack; below this window size the
# single-device RLC (or the split per-signature program) wins
MIN_SPLIT = int(os.environ.get("COMETBFT_TPU_MESH_MIN_SPLIT", "256"))


def split_spans(n: int, ndev: int) -> list[tuple[int, int]]:
    """Contiguous near-equal [start, end) chunks, every chunk
    non-empty; fewer spans than devices when n < ndev."""
    ndev = max(1, min(ndev, n))
    base, rem = divmod(n, ndev)
    spans, start = [], 0
    for i in range(ndev):
        end = start + base + (1 if i < rem else 0)
        spans.append((start, end))
        start = end
    return spans


def _healthy_devices(devices):
    """The mesh rotation as it stands: the port has no device-health
    registry yet, which is the JAX package's behaviour when none is
    installed."""
    return devices


def mesh_devices():
    """The configured mesh's usable devices, or None when the mesh is
    off or leaves fewer than two."""
    from ..ops import sharding

    devices = sharding.mesh_device_list(None)
    if devices is None:
        return None
    devices = _healthy_devices(devices)
    return devices if len(devices) >= 2 else None


def split_rlc_verify(pubkeys: list[bytes], parsed, devices,
                     use_cache: bool | None = None):
    """One multi-commit window split across `devices`: chunk i packs on
    the host and launches its own RLC program on devices[i]; every
    chunk's program is launched before any verdict is read back.
    Returns the per-chunk bool list (one per span), or None when any
    chunk fails structural packing — the caller localizes per signature
    either way."""
    from . import ed25519 as ed

    spans = split_spans(len(pubkeys), len(devices))
    packs = []
    for a, b in spans:
        m = b - a
        packed = ed.pack_rlc(pubkeys[a:b], [b""] * m, [b""] * m,
                             parsed=parsed[a:b])
        if packed is None:
            return None
        packs.append(packed)
    outs = [ed.rlc_verify_async(packed, use_cache=use_cache, device=d)
            for packed, d in zip(packs, devices)]
    return [bool(o) for o in outs]


def maybe_split_verify(pubkeys: list[bytes], parsed,
                       min_split: int | None = None):
    """The crypto/batch._device_verify hook: None when the split does
    not apply (mesh off, too few devices, window under MIN_SPLIT);
    otherwise the whole window's RLC verdict (True: every chunk
    verified; False: some chunk rejected, localize)."""
    if len(pubkeys) < (min_split if min_split is not None else MIN_SPLIT):
        return None
    devices = mesh_devices()
    if devices is None:
        return None
    verdicts = split_rlc_verify(pubkeys, parsed, devices)
    if verdicts is None:
        return False
    return all(verdicts)


def verify_batch_mesh(pubkeys: list[bytes], parsed, devices=None):
    """Per-signature verdicts with the batch axis split over `devices`
    (None: every local card) and the bucket sized so that they divide
    it — the parallel path, one gather of the verdicts."""
    from ..ops import sharding
    from . import ed25519 as ed

    n = len(pubkeys)
    bucket = sharding.auto_bucket(
        n, None if devices is None else len(devices))
    a, r, s, h, valid = ed.pack_batch(pubkeys, [b""] * n, [b""] * n,
                                      bucket, parsed=parsed)
    verdict = sharding.verify_batch_sharded(a, r, s, h, devices=devices)
    return (verdict.cpu().numpy() & valid)[:n].tolist()
