"""K4, the port's RLC epilogue (cometbft_tpu_torch/ops/cuda_msm.py
fold_verify: fold both sides' partials, cofactor 8, identity test), on
the CPU, where the wrapper runs its plain version fold_verify_plain.

fold_verify_plain is held against the JAX package's XLA epilogue (each
side's jdev._tree_reduce, their sum, 3 doublings without T,
point_is_identity) on partial sets made from a numpy seed at ragged
widths: sets that sum to the identity (accept), the same with an
8-torsion point added to one partial (accept: the cofactor clears it),
and the same with one limb of one partial changed (reject).  The CUDA
kernel runs fold_verify_plain's order (FOLD_THREADS slots, strided sums,
the pairwise slot tree) and runs only on the card; its wrapper's kernel
route is checked here up to its argument checks, which raise before
anything is built.

Tolerance: exact — the verdicts are booleans and must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import ed25519 as jdev
from cometbft_tpu_torch.crypto import ed25519_ref as tref
from cometbft_tpu_torch.ops import cuda_msm
from cometbft_tpu_torch.ops import ed25519 as tdev
from cometbft_tpu_torch.ops import fe as tfe

# (na, nr): both sides ragged; 129 and 300 partials cross FOLD_THREADS
WIDTHS = ((1, 1), (64, 65), (173, 127))
TORSION8 = "26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain version runs thousands of small torch ops; beside other
    busy test workers, OpenMP's threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _limbs(pts):
    """[(X, Y, Z, T)] Python ints -> (4, 20, n) int32."""
    return np.stack([np.stack([tfe.int_to_limbs(p[c]) for p in pts], 1)
                     for c in range(4)]).astype(np.int32)


def _identity_set(n, seed):
    """n partials summing to the identity: n - 1 sums Q_a + Q_b over 16
    seeded multiples of B, then minus their sum."""
    rng = np.random.default_rng(seed)
    pool = torch.from_numpy(_limbs([tref.point_mul(int(k), tref.B)
                                    for k in rng.integers(1, 1 << 62, 16)]))
    a, b = (torch.from_numpy(rng.integers(0, 16, n - 1)) for _ in range(2))
    pts = tdev.point_add(pool[..., a], pool[..., b])
    return torch.cat([pts, tdev.point_neg(tdev._tree_reduce(pts, 1))], -1)


def _sets(na, nr):
    """{kind: (4, 20, na + nr) partials, expected verdict}."""
    full = _identity_set(na + nr, na * 1000 + nr)
    tor = full.clone()
    t8 = torch.from_numpy(_limbs([tref.point_decompress(
        bytes.fromhex(TORSION8))]))
    tor[..., -1:] = tdev.point_add(full[..., -1:], t8)
    bad = full.clone()
    bad[(na + nr) % 4, 5, (na + nr) // 2] += 1
    return {"accept": (full, True), "torsion": (tor, True),
            "reject": (bad, False)}


def _xla_epilogue_verdicts(pts, na):
    """(4, 20, sets, n) partials -> one verdict per set, the sets side by
    side in one eager JAX run (each new shape compiles each op once)."""
    pts = jnp.asarray(pts)
    total = jdev.point_add(jdev._tree_reduce(pts[..., :na], 1),
                           jdev._tree_reduce(pts[..., na:], 1))
    for _ in range(3):
        total = jdev.point_double(total, with_t=False)
    return [bool(v) for v in np.asarray(jdev.point_is_identity(total))[:, 0]]


@pytest.mark.parametrize("na, nr", WIDTHS)
def test_fold_verify_plain_matches_xla_epilogue(na, nr):
    sets = _sets(na, nr)
    wants = [want for _, want in sets.values()]
    assert _xla_epilogue_verdicts(
        np.stack([pts.numpy() for pts, _ in sets.values()], axis=2),
        na) == wants
    for kind, (pts, want) in sets.items():
        got = cuda_msm.fold_verify_plain(pts[..., :na].contiguous(),
                                         pts[..., na:].contiguous())
        assert got.dim() == 0 and bool(got) is want, kind


def test_torsion_set_is_not_the_identity_before_the_cofactor():
    """The torsion set sums to the 8-torsion point, not the identity, so
    only the 3 doublings make it accept."""
    pts, _ = _sets(64, 65)["torsion"]
    total = tdev._tree_reduce(pts, 1)
    assert not bool(tdev.point_is_identity(total)[0])
    for _ in range(2):
        total = tdev.point_double(total, with_t=False)
    assert not bool(tdev.point_is_identity(total)[0])     # order 8, not 4
    assert bool(tdev.point_is_identity(
        tdev.point_double(total, with_t=False))[0])


def test_fold_verify_wrapper_runs_plain_on_cpu():
    pts, _ = _sets(173, 127)["accept"]
    cuda_msm.fold_verify.launches = 0
    assert bool(cuda_msm.fold_verify(pts[..., :173], pts[..., 173:]))
    assert cuda_msm.fold_verify.launches == 0
    assert cuda_msm.FOLD_THREADS == 128


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, so a wrapper takes
    its kernel route; the checks below raise before anything is built or
    launched."""

    @property
    def is_cuda(self):
        return True


def _pt(*shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype).as_subclass(_OnCard)


@pytest.mark.parametrize("pa, pr, err", [
    (lambda: _pt(4, 20, 3, dtype=torch.int64), lambda: _pt(4, 20, 2),
     TypeError),
    (lambda: _pt(4, 20, 3), lambda: _pt(4, 19, 2), ValueError),
    (lambda: _pt(20, 3), lambda: _pt(4, 20, 2), ValueError),
], ids=["k4-dtype", "k4-limbs", "k4-rank"])
def test_fold_kernel_route_rejects_wrong_dtype_or_shape(pa, pr, err):
    cuda_msm.fold_verify.launches = 0
    with pytest.raises(err, match="expected"):
        cuda_msm.fold_verify(pa(), pr())
    assert cuda_msm.fold_verify.launches == 0
