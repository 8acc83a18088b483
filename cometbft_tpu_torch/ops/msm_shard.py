"""K8: the RLC program's MSMs with the lane axis split over devices —
the port's counterpart of `cometbft_tpu.ops.msm_shard`.

`sharded_msm` replaces `cometbft_tpu/ops/msm_shard.py::sharded_msm`
(:42) and `rlc_verify_sharded` replaces `rlc_verify_sharded` (:122).
The TPU versions run the Pallas kernels under `shard_map`: each device
builds the window tables of its lane shard and runs the window-major
Straus kernel on it; the per-device accumulator points (4, 20, out_l)
are combined by an `all_gather` and a group-addition fold, since a sum
of points is not an elementwise psum.

K8 has no kernel body of its own.  Here each shard's tensors move to
its device and its programs run there, through the wrappers of K1 and
K2 (tables), K3 (the MSM partials) and K4 (fold and verdict), each
launched under its tensors' device context.  The partials of every
shard are then copied onto devices[0] in device order — the
`_gather_lanes` of the JAX package — and reduced there: by
`_tree_reduce` to one point, or by K4 for the verdict.  What crosses
devices is 320 bytes per partial, a few kilobytes per shard.

Bound: the per-shard kernels' own (operations), run in turn where
shards share a card, in parallel across cards; the gather is bytes.

There is no single program sharded over devices: the JAX package found
that GSPMD-sharding one fused RLC program gave a wrong verdict, so both
packages keep per-device programs and a gather.  The reference's
`interpret`, `blk` and `use_pallas` only pick a route the port does not
have (K3 chooses its own geometry, cuda_msm.msm_geometry), and
`sharded_bucket_msm` waits for the bucket engine (ops/msm.py).

A call whose devices are all CUDA devices counts one launch on the
function (`launches`), so a run can show that it went through K8; the
kernels it runs count their own.
"""

from __future__ import annotations

import torch

from . import cuda_msm
from . import device as devmod
from . import ed25519 as dev


def _spans(width: int, devices) -> list[tuple[int, int]]:
    """Contiguous equal lane shards, one per device."""
    n = len(devices)
    if n < 1:
        raise ValueError("a sharded MSM needs at least one device")
    if width % n:
        raise ValueError(f"width {width} does not split over {n} devices")
    step = width // n
    return [(i * step, (i + 1) * step) for i in range(n)]


def _shard(x: torch.Tensor, span, device) -> torch.Tensor:
    return x[..., span[0]:span[1]].to(device).contiguous()


def _gather_lanes(parts, device) -> torch.Tensor:
    """Per-shard (4, 20, out_l) partials -> (4, 20, sum out_l) on
    `device`, in shard order."""
    return torch.cat([p.to(device) for p in parts], dim=-1)


def _count(fn, devices) -> None:
    if all(torch.device(d).type == "cuda" for d in devices):
        devmod.count_launch(fn)


def sharded_partials(tab, mags, negs, *, devices, group=None):
    """(17, 4, 20, W) tables, (nwin, W) digits -> the shards' K3 (K5
    when the window group is > 1) partials gathered onto devices[0]."""
    spans = _spans(tab.shape[-1], devices)
    parts = [cuda_msm.msm_window_major(
                 _shard(tab, sp, d), _shard(mags, sp, d),
                 _shard(negs, sp, d), group=group)
             for sp, d in zip(spans, devices)]
    return _gather_lanes(parts, devices[0])


def sharded_msm(tab, mags, negs, *, devices, group=None):
    """One lane-sharded MSM: each device's window-major partials on its
    table and digit shard, gathered and tree-folded on devices[0] into
    the (4, 20, 1) MSM point."""
    out = dev._tree_reduce(sharded_partials(tab, mags, negs,
                                            devices=devices, group=group), 1)
    _count(sharded_msm, devices)
    return out


sharded_msm.launches = 0


def rlc_verify_sharded(a_words, r_words, a_mag, a_neg, r_mag, r_neg, *,
                       devices, group=None):
    """Whole-batch RLC verify with both MSM sides lane-sharded over
    `devices`: the multi-device form of ops/ed25519.rlc_verify_kernel.

    Takes the rlc_verify_kernel arguments (on any device) with widths
    the device count divides.  Per shard: decompression and tables (K1,
    K2) and the MSM partials (K3) of both sides; then both sides'
    partials gathered onto devices[0], K4 on them, and the shards'
    decompression flags ANDed in.  Returns the 0-dim bool verdict on
    devices[0]."""
    a_spans = _spans(a_words.shape[-1], devices)
    r_spans = _spans(r_words.shape[-1], devices)
    sides = []
    oks = []
    for spans, words, mags, negs in ((a_spans, a_words, a_mag, a_neg),
                                     (r_spans, r_words, r_mag, r_neg)):
        parts = []
        for sp, d in zip(spans, devices):
            tab, ok = dev.build_a_tables(_shard(words, sp, d))
            parts.append(cuda_msm.msm_window_major(
                tab, _shard(mags, sp, d), _shard(negs, sp, d), group=group))
            oks.append(ok)
        sides.append(_gather_lanes(parts, devices[0]))
    ok = torch.stack([o.to(devices[0]) for o in oks]).all()
    out = ok & cuda_msm.fold_verify(*sides)
    _count(rlc_verify_sharded, devices)
    return out


rlc_verify_sharded.launches = 0
