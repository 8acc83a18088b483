"""K14 of the port (cometbft_tpu_torch/ops/cuda_persig.py, the
per-signature ZIP-215 program after K1) on the CPU: its plain version's
-A table, nibbles and window step against the JAX package's
(cometbft_tpu/ops/ed25519.py _cached_table, _nibbles and verify_kernel's
scan step), its verdicts at bucket 16 against the JAX package's
ed25519_ref on chip_smoke.py's edge lanes, and the wrapper's CPU
contract.  The kernel itself runs only on the card (chip_smoke.py's
`kernels` phase holds it against the plain version there)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import ed25519_ref as jref
from cometbft_tpu.ops import ed25519 as jdev
from cometbft_tpu.ops import fe as jfe
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.ops import cuda_decompress, cuda_persig
from cometbft_tpu_torch.ops import ed25519 as tdev
from cometbft_tpu_torch.ops import fe as tfe

# the plain versions run many small ops: one thread keeps them fast
# beside other test workers
torch.set_num_threads(1)

W = 16

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _points(w, seed):
    """K1-plain points of w encodings made with numpy: multiples of B,
    the hostile encodings, random 32-byte strings (about half decode)."""
    rng = np.random.default_rng(seed)
    encs = [jref.point_compress(jref.point_mul(int(k), jref.B))
            for k in rng.integers(1, 1 << 60, w // 2)]
    encs += [(1 | (1 << 255)).to_bytes(32, "little"),
             (jref.P + 3).to_bytes(32, "little"),
             (jref.P + 1).to_bytes(32, "little")]
    encs += [rng.bytes(32) for _ in range(w - len(encs))]
    words = np.stack([np.frombuffer(e, dtype=np.uint32) for e in encs], 1)
    pt, _ = cuda_decompress.decompress_plain(
        convert.words_from_numpy(words, "cpu"))
    return pt


def _frozen(pt):
    return tfe.freeze(pt.movedim(-2, 0)).movedim(0, -2)


def test_neg_a_table_matches_jax_cached_table():
    """The -A table the plain version builds (K14's order: the cached -A
    as the operand, every row converted once) is the JAX package's
    _cached_table(point_neg(A)) limb for limb."""
    pt = _points(W, 7)
    got = cuda_persig.neg_a_table_plain(pt)
    want = jax.jit(lambda p: jdev._cached_table(jdev.point_neg(p)))(
        jnp.asarray(pt.numpy()))
    assert got.shape == (16, 4, tfe.NLIMBS, W)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_nibbles_match_jax():
    rng = np.random.default_rng(3)
    limbs = rng.integers(0, 1 << 16, (16, W), dtype=np.uint32)
    limbs[:, 0] = 0xFFFF
    limbs[:, 1] = 0
    got = tdev._nibbles(torch.from_numpy(limbs.astype(np.int32)))
    want = jdev._nibbles(jnp.asarray(limbs))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32))


def _jax_step(acc, s_n, h_n, neg_a_tab):
    """The JAX package's verify_kernel scan step, its own functions in
    its order, each point operation jitted once (tracing the step whole
    costs ~30 s here, most of it the unrolled field products)."""
    dbl = jax.jit(jdev.point_double, static_argnums=1)
    add = jax.jit(jdev.add_cached)
    for _ in range(3):
        acc = dbl(acc, False)
    acc = dbl(acc, True)
    acc = add(acc, jax.jit(jdev._select_base)(s_n))
    return add(acc, jax.jit(jdev._select)(neg_a_tab, h_n))


def test_window_step_matches_jax_step():
    """One window of the plain version against the JAX step, on seeded
    accumulators, tables and nibbles (0 and 15 included), at canonical
    value."""
    rng = np.random.default_rng(11)
    acc = _points(W, 12)
    tab = cuda_persig.neg_a_table_plain(_points(W, 13))
    s_n = rng.integers(0, 16, W).astype(np.uint32)
    h_n = rng.integers(0, 16, W).astype(np.uint32)
    s_n[:2], h_n[:2] = (0, 15), (15, 0)
    btab = torch.from_numpy(tdev._BTAB_NP)[..., None]
    got = cuda_persig.window_step_plain(
        acc, btab, tab, torch.from_numpy(s_n.astype(np.int32)),
        torch.from_numpy(h_n.astype(np.int32)))
    want = _jax_step(jnp.asarray(acc.numpy()), jnp.asarray(s_n),
                     jnp.asarray(h_n), jnp.asarray(tab.numpy()))
    want = jnp.moveaxis(jfe.freeze(jnp.moveaxis(want, 1, 0)), 0, 1)
    assert np.array_equal(_frozen(got).numpy(), np.asarray(want))


@pytest.mark.parametrize("bucket", [0, 1])
def test_verdicts_on_edge_lanes_bucket16(bucket):
    """verify_kernel on the CPU (K1's and K14's plain versions) at
    bucket 16 on chip_smoke.py's edge lanes, made with the JAX package's
    ed25519_ref: each verdict is that module's cofactored equation, and
    where the lane is a signature its verify."""
    lanes = chip_smoke._persig_edges(jref)
    lanes = lanes[bucket * W:(bucket + 1) * W]
    want = chip_smoke._persig_oracle(jref, lanes)
    for (label, *_, item), w in zip(lanes, want):
        if item is not None:
            assert jref.verify(*item) == w, label
    arrays = chip_smoke._persig_arrays(lanes)
    got = tdev.verify_kernel(*convert.batch_from_numpy(*arrays, "cpu"))
    assert tdev.bucket_size(len(lanes)) == W
    assert got.tolist() == want, [ln[0] for ln, g, w in
                                  zip(lanes, got.tolist(), want) if g != w]


def test_edge_lanes_cover_the_cofactor():
    """The torsion lane holds only under the cofactored equation, and
    each pattern of verdicts is the one the lanes were built for."""
    lanes = chip_smoke._persig_edges(jref)
    want = chip_smoke._persig_oracle(jref, lanes)
    assert want == [True, False, False] + [True] * 19 + [
        True, False, True, False, True, False, True, False, True, True]
    _, a_enc, r_enc, s, h, _ = next(ln for ln in lanes
                                    if ln[0] == "torsion in R")
    a_pt, r_pt = jref.point_decompress(a_enc), jref.point_decompress(r_enc)
    assert not jref.point_eq(
        jref.point_mul(s, jref.B),
        jref.point_add(r_pt, jref.point_mul(h, a_pt)))


def test_verify_kernel_runs_k1_then_k14(monkeypatch):
    """On CPU tensors verify_kernel runs K1's plain version once on
    A || R and K14's plain version once on its output."""
    calls = []
    k1 = cuda_decompress.decompress_plain

    def k1_spy(words):
        calls.append(("k1", tuple(words.shape)))
        return k1(words)

    def k14_spy(pts, oks, s_limbs, h_limbs, return_acc=False):
        calls.append(("k14", tuple(pts.shape), tuple(oks.shape)))
        return torch.zeros(s_limbs.shape[-1], dtype=torch.bool)

    monkeypatch.setattr(cuda_decompress, "decompress_plain", k1_spy)
    monkeypatch.setattr(cuda_persig, "verify_ladder_plain", k14_spy)
    arrays = chip_smoke._persig_arrays(chip_smoke._persig_edges(jref)[:3])
    launches = cuda_persig.verify_ladder.launches
    out = tdev.verify_kernel(*convert.batch_from_numpy(*arrays, "cpu"))
    assert out.shape == (3,)
    assert calls == [("k1", (8, 6)), ("k14", (4, tfe.NLIMBS, 6), (6,))]
    assert cuda_persig.verify_ladder.launches == launches


def test_plain_accumulator_is_the_verdicts_point():
    """verify_ladder on CPU tensors returns the plain accumulators with
    return_acc, and its verdicts are their identity test."""
    lanes = chip_smoke._persig_edges(jref)[20:24]
    aw, rw, st, ht = convert.batch_from_numpy(
        *chip_smoke._persig_arrays(lanes), "cpu")
    pts, oks = cuda_decompress.decompress_plain(torch.cat([aw, rw], -1))
    got, acc = cuda_persig.verify_ladder(pts, oks, st, ht, return_acc=True)
    assert acc.shape == (4, tfe.NLIMBS, 4)
    assert torch.equal(acc, cuda_persig.ladder_plain(pts, st, ht))
    assert torch.equal(got, oks[:4] & oks[4:] & tdev.point_is_identity(acc))
    assert got.tolist() == chip_smoke._persig_oracle(jref, lanes)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, so the wrapper
    takes its kernel route; the checks below raise before anything is
    built or launched."""

    @property
    def is_cuda(self):
        return True


def _args(n=3):
    return [torch.zeros((4, tfe.NLIMBS, 2 * n), dtype=torch.int32),
            torch.zeros((2 * n,), dtype=torch.bool),
            torch.zeros((16, n), dtype=torch.int32),
            torch.zeros((16, n), dtype=torch.int32)]


@pytest.mark.parametrize("arg,bad,err", [
    (0, torch.zeros((4, tfe.NLIMBS, 6), dtype=torch.int64), TypeError),
    (0, torch.zeros((4, tfe.NLIMBS, 5), dtype=torch.int32), ValueError),
    (0, torch.zeros((tfe.NLIMBS, 6), dtype=torch.int32), ValueError),
    (1, torch.zeros((6,), dtype=torch.int32), TypeError),
    (1, torch.zeros((3,), dtype=torch.bool), ValueError),
    (2, torch.zeros((15, 3), dtype=torch.int32), ValueError),
    (3, torch.zeros((16, 3), dtype=torch.int64), TypeError),
    (3, torch.zeros((16, 4), dtype=torch.int32), ValueError),
], ids=["points-dtype", "points-width", "points-rank", "ok-dtype",
        "ok-width", "s-rows", "h-dtype", "h-width"])
def test_kernel_route_rejects_wrong_dtype_or_shape(arg, bad, err):
    args = _args()
    args[arg] = bad
    args[0] = args[0].as_subclass(_OnCard)
    cuda_persig.verify_ladder.launches = 0
    with pytest.raises(err, match="expected"):
        cuda_persig.verify_ladder(*args)
    assert cuda_persig.verify_ladder.launches == 0
