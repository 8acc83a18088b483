"""The port's plain field layer (cometbft_tpu_torch/ops/fe.py) against
the JAX package's (cometbft_tpu/ops/fe.py): limb for limb, on random
weak-form inputs and on boundary inputs (values near p, limbs at the
multiplier's input bound).  Inputs are made with numpy from fixed seeds
and handed to both."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import fe as jfe
from cometbft_tpu_torch.ops import fe as tfe

W = 24


def _random_weak(seed: int) -> np.ndarray:
    """(20, W) limbs in the weak range [-1220, 9800] that every field op
    emits and takes."""
    rng = np.random.default_rng(seed)
    return rng.integers(-1220, 9801, (tfe.NLIMBS, W), dtype=np.int32)


def _boundary() -> np.ndarray:
    """Columns: p-1, p, p+1, 2**255-1, 0, 1, 19, every limb at +-_MAX_IN,
    every limb at the weak extremes, and canonical digits of 2**260-1."""
    cols = [tfe.int_to_limbs(v) for v in (tfe.P - 1, 0, 1, 19, 2, 38)]
    cols.append(tfe._P_CANON.copy())                      # p itself
    p1 = tfe._P_CANON.copy()
    p1[0] += 1
    cols.append(p1)                                       # p + 1
    top = np.full(tfe.NLIMBS, tfe.MASK, np.int32)
    top[-1] = 0xFF
    cols.append(top)                                      # 2**255 - 1
    cols.append(np.full(tfe.NLIMBS, tfe.MASK, np.int32))  # 2**260 - 1
    cols.append(np.full(tfe.NLIMBS, tfe._MAX_IN, np.int32))
    cols.append(np.full(tfe.NLIMBS, -tfe._MAX_IN, np.int32))
    cols.append(np.full(tfe.NLIMBS, 9800, np.int32))
    cols.append(np.full(tfe.NLIMBS, -1220, np.int32))
    alt = np.where(np.arange(tfe.NLIMBS) % 2 == 0, tfe._MAX_IN, -tfe._MAX_IN)
    cols.append(alt.astype(np.int32))
    return np.stack(cols, axis=1)


def _inputs():
    yield "random0", _random_weak(0), _random_weak(1)
    yield "random2", _random_weak(2), _random_weak(3)
    b = _boundary()
    yield "boundary", b, b[:, ::-1].copy()


CASES = list(_inputs())
IDS = [c[0] for c in CASES]


def _jax(f, *xs):
    return np.asarray(f(*(jnp.asarray(x) for x in xs)))


def _torch(f, *xs):
    return f(*(torch.from_numpy(x) for x in xs)).numpy()


def test_constants_match():
    for name in ("D_LIMBS", "D2_LIMBS", "SQRT_M1_LIMBS", "ONE_LIMBS",
                 "_P_CANON", "_PAD_8P"):
        assert np.array_equal(getattr(tfe, name), getattr(jfe, name)), name
    assert (tfe.NLIMBS, tfe.RADIX, tfe.WRAP, tfe._MAX_IN) == \
        (jfe.NLIMBS, jfe.RADIX, jfe.WRAP, jfe._MAX_IN)


def test_cuda_header_constants_match():
    """The CUDA field layer's literal constants are the plain layer's."""
    src = (Path(tfe.__file__).parent / "csrc" / "fe25519.cuh").read_text()
    for name, want in (("D_LIMBS", tfe.D_LIMBS), ("D2_LIMBS", tfe.D2_LIMBS),
                       ("SQRT_M1_LIMBS", tfe.SQRT_M1_LIMBS),
                       ("PAD_8P", tfe._PAD_8P), ("P_CANON", tfe._P_CANON)):
        body = re.search(name + r"\[NL\] = \{([^}]*)\}", src).group(1)
        got = [int(v) for v in body.replace("\n", " ").split(",")]
        assert got == want.tolist(), name
    assert "WRAP = 608" in src and "RADIX = 13" in src


@pytest.mark.parametrize("name,a,b", CASES, ids=IDS)
def test_mul_sqr_limb_exact(name, a, b):
    assert np.array_equal(_torch(tfe.mul, a, b), _jax(jfe.mul, a, b))
    assert np.array_equal(_torch(tfe.sqr, a), _jax(jfe.sqr, a))
    assert np.array_equal(_torch(lambda x: tfe.mul_word(x, 2), a),
                          _jax(lambda x: jfe.mul_word(x, 2), a))


@pytest.mark.parametrize("name,a,b", CASES, ids=IDS)
def test_carry_add_sub_neg_limb_exact(name, a, b):
    big = a.astype(np.int64) * 9000           # |limb| < 2**27
    big = big.astype(np.int32)
    assert np.array_equal(_torch(tfe._carry_pass, big),
                          _jax(jfe._carry_pass, big))
    assert np.array_equal(_torch(tfe.norm_weak, big),
                          _jax(jfe.norm_weak, big))
    for op in ("add", "sub"):
        assert np.array_equal(_torch(getattr(tfe, op), a, b),
                              _jax(getattr(jfe, op), a, b)), op
    assert np.array_equal(_torch(tfe.neg, a), _jax(jfe.neg, a))


@pytest.mark.parametrize("name,a,b", CASES, ids=IDS)
def test_freeze_eq_limb_exact(name, a, b):
    got = _torch(tfe.freeze, a)
    assert np.array_equal(got, _jax(jfe.freeze, a))
    for i in range(a.shape[1]):
        assert tfe.limbs_to_int(got[:, i]) == tfe.limbs_to_int(a[:, i])
        assert ((got[:, i] >= 0) & (got[:, i] <= tfe.MASK)).all()
    # equal values in different limb forms, and unequal values
    same = tfe.norm_weak(torch.from_numpy(a) + torch.from_numpy(
        np.tile(tfe._PAD_8P[:, None], (1, a.shape[1])))).numpy()
    assert _torch(tfe.eq, a, same).all()
    assert np.array_equal(_torch(tfe.eq, a, b), _jax(jfe.eq, a, b))
    assert np.array_equal(_torch(tfe.is_zero, a), _jax(jfe.is_zero, a))


def test_pow_p58_limb_exact():
    a = np.concatenate([_random_weak(5)[:, :8], _boundary()[:, :8]], axis=1)
    want = np.asarray(jax.jit(jfe.pow_p58)(jnp.asarray(a)))
    assert np.array_equal(_torch(tfe.pow_p58, a), want)
    for i in range(a.shape[1]):
        x = tfe.limbs_to_int(a[:, i])
        assert tfe.limbs_to_int(want[:, i]) == pow(x, (tfe.P - 5) // 8,
                                                   tfe.P)


def test_words32_to_limbs():
    rng = np.random.default_rng(9)
    words = rng.integers(0, 1 << 32, (8, W), dtype=np.uint64).astype(
        np.uint32)
    want = _jax(jfe.words32_to_limbs, words)
    got = tfe.words32_to_limbs(torch.from_numpy(words.view(np.int32))).numpy()
    assert np.array_equal(got, want)
