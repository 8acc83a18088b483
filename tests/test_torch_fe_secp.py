"""The port's secp256k1 field layer (cometbft_tpu_torch/ops/fe_secp.py)
against Python integers and the JAX package's ops/fe_secp.py, limb for
limb: canonical and weak-form (negative-limb) operands, a long chain of
products, the exact freeze at the edges of [0, p) and Fermat inversion."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import fe_secp as jfs
from cometbft_tpu_torch.ops import fe_secp as tfs

torch.set_num_threads(1)

P = tfs.P


def _vals(seed, n):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    vals[:6] = [0, 1, P - 1, P - 977, (1 << 256) - P - 1, 1 << 255]
    return vals


def _limbs(vals):
    return np.stack([tfs.int_to_limbs(v) for v in vals], 1)


def _weak(seed, n):
    """Limbs across the weak-form range [-1800, 4900], as op outputs
    carry them."""
    rng = np.random.default_rng(seed)
    return rng.integers(-1800, 4901, size=(tfs.NLIMBS, n)).astype(np.int32)


OPERANDS = {
    "canonical": lambda: (_limbs(_vals(0, 40)), _limbs(_vals(1, 40)[::-1])),
    "weak": lambda: (_weak(2, 40), _weak(3, 40)),
    "mixed": lambda: (_limbs(_vals(4, 40)), _weak(5, 40)),
}


def test_constants_match_jax_package():
    for name in ("P", "NLIMBS", "RADIX"):
        assert getattr(tfs, name) == getattr(jfs, name)
    assert tfs._WRAP == jfs._WRAP
    for name, jname in (("_P_CANON", "_P_CANON"), ("_PAD_17P", "_PAD_8P"),
                        ("ONE_LIMBS", "ONE_LIMBS")):
        assert (getattr(tfs, name) == getattr(jfs, jname)).all(), name
    for v in _vals(6, 8):
        assert (tfs.int_to_limbs(v) == jfs.int_to_limbs(v)).all()
        assert tfs.limbs_to_int(tfs.int_to_limbs(v)) == v


@pytest.mark.parametrize("op", ["add", "sub", "mul", "sqr", "neg",
                                "norm_weak", "freeze"])
def test_op_matches_jax_limb_for_limb(op):
    for operands in sorted(OPERANDS):
        a, b = OPERANDS[operands]()
        if op in ("add", "sub", "mul"):
            want = getattr(jfs, op)(jnp.asarray(a), jnp.asarray(b))
            got = getattr(tfs, op)(torch.from_numpy(a), torch.from_numpy(b))
        else:
            want = getattr(jfs, op)(jnp.asarray(a))
            got = getattr(tfs, op)(torch.from_numpy(a))
        assert got.dtype == torch.int32
        assert (got.numpy() == np.asarray(want)).all(), operands


@pytest.mark.parametrize("operands", sorted(OPERANDS))
def test_ops_match_integers(operands):
    a, b = OPERANDS[operands]()
    ia = [tfs.limbs_to_int(a[:, i]) for i in range(a.shape[1])]
    ib = [tfs.limbs_to_int(b[:, i]) for i in range(b.shape[1])]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name, got, fn in (
            ("add", tfs.add(ta, tb), lambda x, y: x + y),
            ("sub", tfs.sub(ta, tb), lambda x, y: x - y),
            ("mul", tfs.mul(ta, tb), lambda x, y: x * y),
            ("neg", tfs.neg(ta), lambda x, y: -x),
            ("mul_word", tfs.mul_word(ta, 977), lambda x, y: 977 * x)):
        out = tfs.freeze(got).numpy()
        assert out.min() >= 0 and out.max() <= tfs.MASK, name
        assert [tfs.limbs_to_int(out[:, i]) for i in range(out.shape[1])] \
            == [fn(x, y) % P for x, y in zip(ia, ib)], name
        assert int(got.abs().max()) <= 5000, name


def test_predicates_at_the_edges():
    vals = [0, P, 2 * P, 1, P - 1, P + 1]
    # the same values as unreduced limbs (p and 2p do not fit canonical
    # digits; spell them in weak form by adding p's digits)
    limbs = np.stack([tfs.int_to_limbs(v % P) + (v // P) * tfs._P_CANON
                      for v in vals], 1).astype(np.int32)
    t = torch.from_numpy(limbs)
    assert tfs.is_zero(t).tolist() == [True, True, True, False, False,
                                       False]
    assert (tfs.is_zero(t).numpy() == np.asarray(jfs.is_zero(
        jnp.asarray(limbs)))).all()
    assert tfs.eq(t, torch.from_numpy(
        np.stack([tfs.int_to_limbs(v % P) for v in vals], 1))).all()


def test_deep_chain_stays_in_bounds():
    """24 alternating sub / mul steps on weak-form operands, against
    integers and the JAX package at the end (the spill-borrow fault the
    JAX module's note describes showed only after dozens of ops)."""
    vals = _vals(7, 16)
    x = _limbs(vals)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    ty, jy, want = tx, jx, list(vals)
    for step in range(24):
        if step % 3 == 0:
            ty, jy = tfs.sub(ty, tx), jfs.sub(jy, jx)
            want = [(w - v) % P for w, v in zip(want, vals)]
        ty, jy = tfs.mul(ty, tx), jfs.mul(jy, jx)
        want = [w * v % P for w, v in zip(want, vals)]
        assert int(ty.abs().max()) < 6000
    assert (ty.numpy() == np.asarray(jy)).all()
    out = tfs.freeze(ty).numpy()
    assert [tfs.limbs_to_int(out[:, i]) for i in range(16)] == want


def test_inv():
    vals = [v for v in _vals(8, 8) if v]
    got = tfs.freeze(tfs.inv(torch.from_numpy(_limbs(vals)))).numpy()
    assert [tfs.limbs_to_int(got[:, i]) for i in range(len(vals))] == \
        [pow(v, P - 2, P) for v in vals]
    zero = tfs.inv(torch.from_numpy(_limbs([0])))
    assert tfs.is_zero(zero).all()
