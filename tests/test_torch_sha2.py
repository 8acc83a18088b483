"""The port's SHA-2 module (cometbft_tpu_torch/ops/sha2.py) on the CPU.

The plain versions of kernels K9 (sha512_blocks) and K10 (sha256_blocks)
against the JAX package's ops/sha2 functions (jitted once per shape) and
against hashlib, at the padding boundaries of one, two and three blocks
and with rows whose block count is 0; the host pad helpers byte for byte
against the JAX package's; and the wrappers' kernel route, which must
refuse a wrong dtype, shape or contiguity before anything is built (the
kernels themselves run only on the card: chip_smoke.py)."""

import hashlib
import random

import jax
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import sha2 as jsha2
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.ops import sha2

torch.set_num_threads(1)   # many small ops; no OpenMP spin beside busy workers

# R||A||M lengths at SHA-512's padding boundaries (111/112: one block or
# two; 127/128: the block edge; 239/240: two blocks or three), and
# SHA-256's (55/56, 63/64, 119/120)
SIZES_512 = [0, 1, 64, 111, 112, 127, 128, 129, 200, 239, 240]
SIZES_256 = [0, 1, 40, 55, 56, 63, 64, 65, 119, 120]


def _msgs(sizes, seed):
    rng = random.Random(seed)
    return [bytes(rng.randrange(256) for _ in range(s)) for s in sizes]


def _zero_rows(nb, every=4):
    """n_blocks with every `every`-th row set to 0 (filler rows)."""
    nb = nb.copy()
    nb[::every] = 0
    return nb


def _t(arr):
    return convert.words_from_numpy(arr, "cpu")


def test_sha512_plain_matches_jax_and_hashlib():
    msgs = _msgs(SIZES_512, 1)
    hi, lo, nb = sha2.pad_sha512(msgs, 3)
    nb0 = _zero_rows(nb)
    got_hi, got_lo = sha2.sha512_blocks(_t(hi), _t(lo), torch.from_numpy(nb0))
    want_hi, want_lo = jax.jit(jsha2.sha512_blocks)(hi, lo, nb0)
    np.testing.assert_array_equal(got_hi.numpy().view(np.uint32),
                                  np.asarray(want_hi))
    np.testing.assert_array_equal(got_lo.numpy().view(np.uint32),
                                  np.asarray(want_lo))
    init = [v >> 32 for v in sha2.H512], [v & sha2.M32 for v in sha2.H512]
    for i, m in enumerate(msgs):
        digest = sha2.digest512_to_bytes(got_hi[i].numpy(),
                                         got_lo[i].numpy())
        if nb0[i]:
            assert digest == hashlib.sha512(m).digest(), len(m)
        else:                          # the initial state, blocks unread
            assert digest == sha2.digest512_to_bytes(*init)


def test_sha256_plain_matches_jax_and_hashlib():
    msgs = _msgs(SIZES_256, 2)
    blocks, nb = sha2.pad_sha256(msgs)
    nb0 = _zero_rows(nb, 3)
    got = sha2.sha256_blocks(_t(blocks), torch.from_numpy(nb0))
    want = jax.jit(jsha2.sha256_blocks)(blocks, nb0)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    for i, m in enumerate(msgs):
        digest = sha2.digest256_to_bytes(got[i].numpy())
        assert digest == (hashlib.sha256(m).digest() if nb0[i]
                          else sha2.digest256_to_bytes(sha2.H256)), len(m)


def test_block_counts_past_the_bucket_are_clamped_as_in_jax():
    """A count above B reads B blocks and a negative one none, as the
    JAX scan's mask does."""
    msgs = _msgs([10, 150, 250], 3)
    hi, lo, nb = sha2.pad_sha512(msgs, 3)
    nb = np.array([7, -1, 3], dtype=np.int32)
    got = sha2.sha512_blocks(_t(hi), _t(lo), torch.from_numpy(nb))
    want = jsha2.sha512_blocks(hi, lo, nb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w))


@pytest.mark.parametrize("max_blocks", [None, 3])
def test_pad_helpers_match_jax(max_blocks):
    msgs = _msgs(SIZES_512, 4)
    for got, want in zip(sha2.pad_sha512(msgs, max_blocks),
                         jsha2.pad_sha512(msgs, max_blocks)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    msgs = _msgs(SIZES_256, 5)
    for got, want in zip(sha2.pad_sha256(msgs, max_blocks and 4),
                         jsha2.pad_sha256(msgs, max_blocks and 4)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_pad_matrix_matches_jax():
    msgs = _msgs([3, 111, 112, 240], 6)
    lens = np.array([len(m) for m in msgs], dtype=np.int64)
    mats = []
    for _ in range(2):
        mat = np.zeros((len(msgs), 3 * 128), dtype=np.uint8)
        for i, m in enumerate(msgs):
            mat[i, :len(m)] = np.frombuffer(m, dtype=np.uint8)
        mats.append(mat)
    got = sha2.pad_sha512_matrix(mats[0], lens)
    want = jsha2.pad_sha512_matrix(mats[1], lens)
    assert mats[0].tobytes() == mats[1].tobytes()    # padded in place alike
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_oversized_message_raises_as_in_jax():
    for pad in (sha2.pad_sha512, jsha2.pad_sha512):
        with pytest.raises(ValueError, match="message exceeds max_blocks"):
            pad([b"x" * 241], 2)
    for pad in (sha2.pad_sha256, jsha2.pad_sha256):
        with pytest.raises(ValueError, match="message exceeds max_blocks"):
            pad([b"x" * 56], 1)


def test_digest_to_bytes_match_jax():
    rng = np.random.default_rng(7)
    w = rng.integers(0, 1 << 32, 8, dtype=np.uint64).astype(np.uint32)
    v = rng.integers(0, 1 << 32, 8, dtype=np.uint64).astype(np.uint32)
    assert sha2.digest256_to_bytes(w) == jsha2.digest256_to_bytes(w)
    assert sha2.digest256_to_bytes(w.view(np.int32)) == \
        jsha2.digest256_to_bytes(w)
    assert sha2.digest512_to_bytes(w, v) == jsha2.digest512_to_bytes(w, v)
    assert sha2.digest512_to_bytes(w.view(np.int32), v.view(np.int32)) == \
        jsha2.digest512_to_bytes(w, v)


# -- the kernel route ---------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, so a wrapper takes
    its kernel route; the checks below raise before anything is built or
    launched."""

    @property
    def is_cuda(self):
        return True


def _c(*shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype).as_subclass(_OnCard)


def _strided(*shape):
    return torch.zeros(shape[:-1] + (2 * shape[-1],),
                       dtype=torch.int32)[..., ::2].as_subclass(_OnCard)


K9_BAD = {
    "dtype": (lambda: (_c(4, 3, 16, dtype=torch.int64), _c(4, 3, 16),
                       _c(4)), TypeError),
    "words": (lambda: (_c(4, 3, 15), _c(4, 3, 15), _c(4)), ValueError),
    "rank": (lambda: (_c(4, 48), _c(4, 48), _c(4)), ValueError),
    "lo-shape": (lambda: (_c(4, 3, 16), _c(4, 2, 16), _c(4)), ValueError),
    "lo-dtype": (lambda: (_c(4, 3, 16), _c(4, 3, 16, dtype=torch.uint8),
                          _c(4)), TypeError),
    "counts-shape": (lambda: (_c(4, 3, 16), _c(4, 3, 16), _c(5)),
                     ValueError),
    "counts-dtype": (lambda: (_c(4, 3, 16), _c(4, 3, 16),
                              _c(4, dtype=torch.int64)), TypeError),
    "contiguity": (lambda: (_strided(4, 3, 16), _c(4, 3, 16), _c(4)),
                   ValueError),
}


@pytest.mark.parametrize("case", sorted(K9_BAD))
def test_k9_kernel_route_refuses(case):
    args, err = K9_BAD[case]
    sha2.sha512_blocks.launches = 0
    with pytest.raises(err, match="expected"):
        sha2.sha512_blocks(*args())
    assert sha2.sha512_blocks.launches == 0


K10_BAD = {
    "dtype": (lambda: (_c(4, 1, 16, dtype=torch.int64), _c(4)), TypeError),
    "words": (lambda: (_c(4, 1, 8), _c(4)), ValueError),
    "rank": (lambda: (_c(4, 16), _c(4)), ValueError),
    "counts-shape": (lambda: (_c(4, 1, 16), _c(3)), ValueError),
    "contiguity": (lambda: (_strided(4, 1, 16), _c(4)), ValueError),
    "counts-contiguity": (lambda: (_c(4, 1, 16), _strided(4)), ValueError),
}


@pytest.mark.parametrize("case", sorted(K10_BAD))
def test_k10_kernel_route_refuses(case):
    args, err = K10_BAD[case]
    sha2.sha256_blocks.launches = 0
    with pytest.raises(err, match="expected"):
        sha2.sha256_blocks(*args())
    assert sha2.sha256_blocks.launches == 0


def test_cpu_tensors_take_the_plain_route(monkeypatch):
    """A CPU tensor runs the plain version and launches nothing."""
    calls = []

    def spy(fn):
        def wrapped(*a):
            calls.append(fn.__name__)
            return fn(*a)
        return wrapped

    monkeypatch.setattr(sha2, "sha512_blocks_plain",
                        spy(sha2.sha512_blocks_plain))
    monkeypatch.setattr(sha2, "sha256_blocks_plain",
                        spy(sha2.sha256_blocks_plain))
    hi, lo, nb = sha2.pad_sha512([b"abc"])
    sha2.sha512_blocks(_t(hi), _t(lo), torch.from_numpy(nb))
    blocks, nb = sha2.pad_sha256([b"abc"])
    sha2.sha256_blocks(_t(blocks), torch.from_numpy(nb))
    assert calls == ["sha512_blocks_plain", "sha256_blocks_plain"]
