"""The port's host packers and state conversion against the JAX
package's: pack_rlc and pack_batch arrays byte-equal when both get the
same weights, the signed-window recode against its scalar oracle, and
convert.py carrying the packed batch and an A-table across — a table the
JAX package built verifies the same batch, with the same verdict, as one
the port built."""

import secrets

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.ops import ed25519 as jdev
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.ops import ed25519 as tdev


def _batch(n, n_keys, seed):
    """n signatures by n_keys keys (repeats exercise the aggregation);
    signed with the JAX package's keys, which are the port's bytes."""
    rng = np.random.default_rng(seed)
    privs = [jed.PrivKey.generate(rng.bytes(32)) for _ in range(n_keys)]
    pks, msgs, sigs = [], [], []
    for i in range(n):
        k = privs[i % n_keys]
        m = rng.bytes(100 + i % 7)
        pks.append(k.pub_key().bytes())
        msgs.append(m)
        sigs.append(k.sign(m))
    return pks, msgs, sigs


def _weights(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(16), "little") for _ in range(n)]


def _jax_pack_rlc(monkeypatch, pks, msgs, sigs, zs):
    it = iter(zs)
    monkeypatch.setattr(secrets, "randbits", lambda k: next(it))
    return jed.pack_rlc(pks, msgs, sigs)


@pytest.mark.parametrize("n,n_keys", [(9, 3), (40, 40), (200, 7)])
def test_pack_rlc_byte_equal(monkeypatch, n, n_keys):
    pks, msgs, sigs = _batch(n, n_keys, seed=n)
    zs = _weights(n, seed=n + 1)
    got = ted.pack_rlc(pks, msgs, sigs, z=zs)
    want = _jax_pack_rlc(monkeypatch, pks, msgs, sigs, zs)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_pack_rlc_structural_reject_and_empty():
    pks, msgs, sigs = _batch(4, 2, seed=3)
    sigs[2] = sigs[2][:32] + (ted.L + 1).to_bytes(32, "little")
    assert ted.pack_rlc(pks, msgs, sigs) is None
    assert jed.pack_rlc(pks, msgs, sigs) is None
    assert ted.pack_rlc([], [], []) is None


def test_pack_batch_and_parse_byte_equal():
    pks, msgs, sigs = _batch(10, 4, seed=5)
    sigs[1] = sigs[1][:32] + (ted.L + 1).to_bytes(32, "little")
    pks[3] = pks[3][:31]                                  # short key
    assert ted.parse_and_hash(pks, msgs, sigs) == \
        jed.parse_and_hash(pks, msgs, sigs)
    got = ted.pack_batch(pks, msgs, sigs, 16)
    want = jed.pack_batch(pks, msgs, sigs, 16)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("ndig,bits", [(26, 128), (52, 253)])
def test_recode_w5_matches_scalar_and_jax(ndig, bits):
    rng = np.random.default_rng(ndig)
    vals = [int.from_bytes(rng.bytes(32), "little") % (1 << bits)
            for _ in range(30)]
    vals += [0, 1, 15, 16, 17, 31, (1 << bits) - 1]
    if bits == 253:
        vals.append(ted.L - 1)
    width = 48
    got = ted._recode_w5(vals, ndig, width)
    for g, w in zip(got, ted._recode_w5_scalar(vals, ndig, width)):
        assert np.array_equal(g, w)
    for g, w in zip(got, jed._recode_w5(vals, ndig, width)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # digits reassemble the value
    mag, neg = got
    for i, v in enumerate(vals):
        acc = 0
        for j in range(ndig):
            acc = 32 * acc + (-1 if neg[j, i] else 1) * int(mag[j, i])
        assert acc == v


def test_convert_round_trip():
    pks, msgs, sigs = _batch(12, 5, seed=8)
    packed = ted.pack_rlc(pks, msgs, sigs)
    t = convert.packed_from_numpy(packed, "cpu")
    assert [x.dtype for x in t] == [torch.int32, torch.int32, torch.int32,
                                    torch.bool, torch.int32, torch.bool]
    assert t[0].numpy().view(np.uint32).tobytes() == packed[0].tobytes()
    assert t[1].numpy().view(np.uint32).tobytes() == packed[1].tobytes()
    for got, want in zip(t[2:], packed[2:]):
        assert np.array_equal(got.numpy(), want)
    tab = np.arange(17 * 4 * 20 * 3, dtype=np.int32).reshape(17, 4, 20, 3)
    a_tab, a_ok = convert.a_table_from_numpy(tab, np.bool_(True), "cpu")
    assert np.array_equal(a_tab.numpy(), tab) and bool(a_ok)


def test_jax_built_a_table_verifies_like_port_built():
    """A validator set's A-table built by the JAX package
    (build_a_tables_device) and by the port verify the same batch with
    the same verdict through the port's cached-A program — accept, and
    reject after tampering one signature."""
    pks, msgs, sigs = _batch(8, 8, seed=11)
    packed = ted.pack_rlc(pks, msgs, sigs)
    a_tab_j, a_ok_j = jdev.build_a_tables_device(packed[0])
    entry_j = convert.a_table_from_numpy(np.asarray(a_tab_j),
                                         np.asarray(a_ok_j), "cpu")
    entry_t = tdev.build_a_tables(convert.words_from_numpy(packed[0], "cpu"))
    assert np.array_equal(entry_j[0].numpy(), entry_t[0].numpy())
    for tamper in (False, True):
        if tamper:
            s = bytearray(sigs[4])
            s[7] ^= 1
            sigs[4] = bytes(s)
        packed = ted.pack_rlc(pks, msgs, sigs)
        t = convert.packed_from_numpy(packed, "cpu")
        verdicts = [bool(tdev.rlc_verify_kernel_cached_a(
            *entry, *t[1:])) for entry in (entry_j, entry_t)]
        assert verdicts == [not tamper] * 2


def test_a_table_cache_policy():
    """Second sighting of a large validator set builds its table, the
    third hits it; small sets never cache."""
    cache = ted.ATableCache(capacity=2)
    pks, msgs, sigs = _batch(70, 70, seed=12)
    a_words = ted.pack_rlc(pks, msgs, sigs)[0]
    assert a_words.shape[-1] >= cache.MIN_K
    assert cache.get_if_worthwhile(a_words, "cpu") is None
    assert cache.misses == 0
    first = cache.get_if_worthwhile(a_words, "cpu")
    assert first is not None and (cache.hits, cache.misses) == (0, 1)
    again = cache.get_if_worthwhile(a_words, "cpu")
    assert again[0] is first[0] and (cache.hits, cache.misses) == (1, 1)
    assert cache.bytes_resident == ted.BYTES_PER_A_SLOT * a_words.shape[-1]
    small = a_words[:, :8].copy()
    assert cache.get_if_worthwhile(small, "cpu") is None
    assert cache.get_if_worthwhile(small, "cpu") is None
