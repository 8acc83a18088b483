"""K1 and K2 of the port (cometbft_tpu_torch/ops/cuda_decompress.py,
cuda_msm.table17_neg) against the JAX package's XLA twins at ragged
widths (1, 7 and 129 lanes: less than a warp's quads, a part of a
block, one lane past a block), limb for limb, and the wrappers' CPU
contract.  The inputs are made with numpy from fixed seeds: random
32-byte encodings plus every decompression edge (y >= p, x = 0 with the
sign bit set, u/v not a square)."""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import ed25519 as jdev
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ed25519_ref as tref
from cometbft_tpu_torch.ops import cuda_decompress, cuda_msm
from cometbft_tpu_torch.ops import fe as tfe

# the plain versions run many small ops: one thread keeps them fast
# beside other test workers
torch.set_num_threads(1)

WIDTHS = (1, 7, 129)


@pytest.fixture(scope="module", autouse=True)
def _frozen_heap():
    """After each test's own objects are collected, the heap is frozen
    for the next: the per-test gc.collect() of the leak checks walks only
    what one test made.  Unfrozen at the module's end."""
    yield
    gc.unfreeze()


@pytest.fixture(autouse=True)
def _freeze_heap():
    gc.freeze()


def _edge_encodings():
    """Encodings at every decompression edge, hostile ones first."""
    p = tfe.P
    non_square = [y for y in range(2, 64)
                  if tref.point_decompress(y.to_bytes(32, "little")) is None]
    return [
        (1 | (1 << 255)).to_bytes(32, "little"),   # x = 0, sign 1: reject
        (p + 3).to_bytes(32, "little"),            # y >= p, on the curve
        (p + 1).to_bytes(32, "little"),            # y = p + 1: the identity
        ((1 << 255) - 1).to_bytes(32, "little"),   # y = 2^255 - 1 >= p
        non_square[0].to_bytes(32, "little"),      # u/v not a square
        (non_square[1] | (1 << 255)).to_bytes(32, "little"),
        bytes.fromhex("26e8958fc2b227b045c3f489f2ef98f0"
                      "d5dfac05d3c63339b13802886d53fc05"),   # 8-torsion
        tref.point_compress(tref.point_mul(977, tref.B)),
    ]


def _words(w, seed):
    """(8, w) uint32 words: the edges (as many as fit), then random
    32-byte strings (about half of them decode)."""
    rng = np.random.default_rng(seed)
    encs = _edge_encodings()[:w]
    encs += [rng.bytes(32) for _ in range(w - len(encs))]
    return np.stack([np.frombuffer(e, dtype=np.uint32) for e in encs], 1)


@pytest.mark.parametrize("w", WIDTHS)
def test_decompress_plain_matches_xla_twin_ragged(w):
    words = _words(w, 100 + w)
    want_pt, want_ok = jdev.decompress(jnp.asarray(words))
    got_pt, got_ok = cuda_decompress.decompress_plain(
        convert.words_from_numpy(words, "cpu"))
    assert got_pt.shape == (4, tfe.NLIMBS, w)
    assert np.array_equal(got_pt.numpy(), np.asarray(want_pt))
    assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))
    encs = [words[:, i].tobytes() for i in range(w)]
    assert got_ok.numpy().tolist() == [tref.point_decompress(e) is not None
                                       for e in encs]
    if w >= 7:          # the rejects: x = 0 with sign 1, u/v not a square
        assert got_ok.numpy()[[0, 1, 2, 4, 5, 6]].tolist() == [
            False, True, True, False, False, True]


@pytest.mark.parametrize("w", WIDTHS)
def test_table17_neg_plain_matches_xla_twin_ragged(w):
    # points as K1 hands them to K2: decompressed, rejected lanes included
    pts, _ = cuda_decompress.decompress_plain(
        convert.words_from_numpy(_words(w, 200 + w), "cpu"))
    pts = pts.numpy()
    want = np.asarray(jdev._table17(jdev.point_neg(jnp.asarray(pts))))
    got = cuda_msm.table17_neg_plain(torch.from_numpy(pts)).numpy()
    assert got.shape == (17, 4, tfe.NLIMBS, w)
    assert np.array_equal(got, want)


def test_wrappers_on_cpu_tensors_run_plain_and_launch_nothing():
    cuda_decompress.decompress.launches = 0
    cuda_msm.table17_neg.launches = 0
    words = convert.words_from_numpy(_words(7, 7), "cpu")
    pt, ok = cuda_decompress.decompress(words)
    want_pt, want_ok = cuda_decompress.decompress_plain(words)
    assert torch.equal(pt, want_pt) and torch.equal(ok, want_ok)
    tab = cuda_msm.table17_neg(pt)
    assert torch.equal(tab, cuda_msm.table17_neg_plain(pt))
    assert cuda_decompress.decompress.launches == 0
    assert cuda_msm.table17_neg.launches == 0


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, so a wrapper takes
    its kernel route; the checks below raise before anything is built or
    launched."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("kernel,arg,err", [
    ("decompress", torch.zeros((8, 5), dtype=torch.int64), TypeError),
    ("decompress", torch.zeros((7, 5), dtype=torch.int32), ValueError),
    ("decompress", torch.zeros((8,), dtype=torch.int32), ValueError),
    ("table17_neg", torch.zeros((4, 20, 3), dtype=torch.float32), TypeError),
    ("table17_neg", torch.zeros((4, 19, 3), dtype=torch.int32), ValueError),
    ("table17_neg", torch.zeros((17, 4, 20, 3), dtype=torch.int32),
     ValueError),
], ids=["k1-dtype", "k1-rows", "k1-rank", "k2-dtype", "k2-limbs",
        "k2-rank"])
def test_kernel_route_rejects_wrong_dtype_or_shape(kernel, arg, err):
    fn = (cuda_decompress.decompress if kernel == "decompress"
          else cuda_msm.table17_neg)
    fn.launches = 0
    with pytest.raises(err, match="expected"):
        fn(arg.as_subclass(_OnCard))
    assert fn.launches == 0

