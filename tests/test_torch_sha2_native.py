"""K9 and K10's shared design (cometbft_tpu_torch/ops/csrc/sha2.cuh) on
the CPU.

The header's round, schedule step and KW chunk (K + W of 16 rounds)
compile as host C++ with g++ (__device__ defined away, a host funnel
shift; skipped without g++).  The round and the schedule step are held
against Python integers; then a host harness hashes in the kernel's
order, group by group of 32 messages: the schedule warp's KW chunks for
every lane first, laid out [round][message] with the lanes past their
count staged as zeros, then the round warp's rounds reading that layout,
each lane's state added only for blocks below its clamped count.  Its
digests are held against hashlib and against the JAX package's jitted
sha512_blocks / sha256_blocks at the padding boundaries, counts of 0,
counts above B and below 0, a group of 32 whose counts run 0..B, and
seeded random lengths over ragged groups.  Inputs come from numpy seeds;
every comparison is exact."""

import ctypes
import hashlib
import shutil
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import sha2 as jsha2
from cometbft_tpu_torch.ops import sha2

torch.set_num_threads(1)

CSRC = Path(sha2.__file__).parent / "csrc"
M64 = (1 << 64) - 1
M32 = (1 << 32) - 1

_HARNESS = r"""
#include <cstdint>
#include <cstring>
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, int n) {
  n &= 31;
  return n ? (lo >> n) | (hi << (32 - n)) : lo;
}
#define __device__
#define __forceinline__ inline
#define __constant__
#include "sha2.cuh"
using namespace sha2;

// the kernel's order, one group of 32 messages at a time
template <class T>
static void hash_groups(const uint32_t* in0, const uint32_t* in1,
                        const int32_t* nblocks, int64_t n, int nmax,
                        uint32_t* out0, uint32_t* out1) {
  typedef typename T::word W;
  const int NCHUNK = T::ROUNDS / 16;
  static W ring[T::ROUNDS][32];
  for (int64_t m0 = 0; m0 < n; m0 += 32) {
    int nb[32], nbmax = 0;
    W s[32][8];
    for (int l = 0; l < 32; ++l) {
      nb[l] = m0 + l < n ? clamp_blocks(nblocks[m0 + l], nmax) : 0;
      nbmax = nb[l] > nbmax ? nb[l] : nbmax;
      for (int i = 0; i < 8; ++i) s[l][i] = T::h(i);
    }
    for (int b = 0; b < nbmax; ++b) {
      for (int l = 0; l < 32; ++l) {           // the schedule warp
        uint32_t row0[16] = {0}, row1[16] = {0};
        if (b < nb[l]) {
          const int64_t off = ((m0 + l) * nmax + b) * 16;
          memcpy(row0, in0 + off, sizeof row0);
          if (T::HALVES == 2) memcpy(row1, in1 + off, sizeof row1);
        }
        W w[16];
        for (int j = 0; j < 16; ++j) w[j] = T::join(row0, row1, j);
        for (int c = 0; c < NCHUNK; ++c)
          kw_chunk<T>(w, c, c > 0, &ring[16 * c][l], 32);
      }
      for (int l = 0; l < 32; ++l) {           // the round warp
        W v[8];
        for (int i = 0; i < 8; ++i) v[i] = s[l][i];
        for (int c = 0; c < NCHUNK; ++c)
          rounds_chunk<T>(v, &ring[16 * c][l], 32);
        if (b < nb[l])
          for (int i = 0; i < 8; ++i) s[l][i] += v[i];
      }
    }
    for (int l = 0; l < 32 && m0 + l < n; ++l)
      for (int i = 0; i < 8; ++i) T::store(out0, out1, (m0 + l) * 8 + i, s[l][i]);
  }
}

extern "C" {
void h_sha512(const uint32_t* hi, const uint32_t* lo, const int32_t* nb,
              int64_t n, int nmax, uint32_t* ohi, uint32_t* olo) {
  hash_groups<Sha512>(hi, lo, nb, n, nmax, ohi, olo);
}
void h_sha256(const uint32_t* in, const int32_t* nb, int64_t n, int nmax,
              uint32_t* out) {
  hash_groups<Sha256>(in, nullptr, nb, n, nmax, out, nullptr);
}
void h_round512(uint64_t* s, int r, uint64_t kw) { sha_round<Sha512>(s, r, kw); }
void h_round256(uint32_t* s, int r, uint32_t kw) { sha_round<Sha256>(s, r, kw); }
void h_step512(uint64_t* w, int r) { schedule_step<Sha512>(w, r); }
void h_step256(uint32_t* w, int r) { schedule_step<Sha256>(w, r); }
}
"""


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """sha2.cuh compiled as host C++ behind a C interface."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the header for the host")
    d = tmp_path_factory.mktemp("sha2_native")
    (d / "harness.cpp").write_text(_HARNESS)
    so = d / "libharness.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(CSRC),
                    str(d / "harness.cpp"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.h_sha512.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.h_sha256.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    for bits in (512, 256):
        word = ctypes.c_uint64 if bits == 512 else ctypes.c_uint32
        getattr(lib, f"h_round{bits}").argtypes = [ctypes.c_void_p,
                                                   ctypes.c_int, word]
        getattr(lib, f"h_step{bits}").argtypes = [ctypes.c_void_p,
                                                  ctypes.c_int]
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


# -- the round and the schedule step against Python integers ------------------

def _rotr(x, n, bits):
    return ((x >> n) | (x << (bits - n))) & ((1 << bits) - 1)


SPEC = {  # bits: (Sigma0, Sigma1, sigma0, sigma1) rotations and shifts
    512: ((28, 34, 39), (14, 18, 41), (1, 8, 7), (19, 61, 6)),
    256: ((2, 13, 22), (6, 11, 25), (7, 18, 3), (17, 19, 10)),
}
WORD_BITS = {512: 64, 256: 32}


def _big(x, rots, bits):
    return _rotr(x, rots[0], bits) ^ _rotr(x, rots[1], bits) ^ \
        _rotr(x, rots[2], bits)


def _small(x, spec, bits):
    return _rotr(x, spec[0], bits) ^ _rotr(x, spec[1], bits) ^ (x >> spec[2])


def _round_py(st, kw, bits):
    """FIPS 180-4's round on (a, ..., h), kw = K + W."""
    wb = WORD_BITS[bits]
    mask = (1 << wb) - 1
    a, b, c, d, e, f, g, h = st
    big0, big1 = SPEC[bits][0], SPEC[bits][1]
    t1 = (h + _big(e, big1, wb) + ((e & f) ^ (~e & mask & g)) + kw) & mask
    t2 = (_big(a, big0, wb) + ((a & b) ^ (a & c) ^ (b & c))) & mask
    return [(t1 + t2) & mask, a, b, c, (d + t1) & mask, e, f, g]


@pytest.mark.parametrize("bits", [512, 256])
def test_rounds_in_place_match_fips(native, bits):
    """16 rounds of sha_round on the state in place (variable v in slot
    (v - r) & 7) equal FIPS 180-4's rounds, edge and seeded values."""
    rng = np.random.default_rng(bits)
    mask = M64 if bits == 512 else M32
    dt = np.uint64 if bits == 512 else np.uint32
    fn = getattr(native, f"h_round{bits}")
    for trial in range(40):
        if trial < 2:
            st = [mask * trial] * 8
            kws = [mask * trial] * 16
        else:
            st, kws = ([int(x) for x in rng.integers(
                0, mask, k, dtype=dt, endpoint=True)] for k in (8, 16))
        s = np.array(st, dtype=dt)
        want = list(st)
        for r, kw in enumerate(kws):
            fn(_ptr(s), r, kw)
            want = _round_py(want, kw, bits)
        assert [int(x) for x in s] == want, trial


@pytest.mark.parametrize("bits", [512, 256])
def test_schedule_steps_match_fips(native, bits):
    """schedule_step over a 16-word window equals W[i] = sigma1(W[i-2]) +
    W[i-7] + sigma0(W[i-15]) + W[i-16] for rounds 16 .. ROUNDS - 1."""
    rng = np.random.default_rng(bits + 1)
    mask = M64 if bits == 512 else M32
    dt = np.uint64 if bits == 512 else np.uint32
    rounds = 80 if bits == 512 else 64
    fn = getattr(native, f"h_step{bits}")
    for trial in range(20):
        w0 = ([mask] * 16 if trial == 0 else
              [int(x) for x in rng.integers(0, mask, 16, dtype=dt,
                                            endpoint=True)])
        full = list(w0)
        for i in range(16, rounds):
            wb = WORD_BITS[bits]
            full.append((_small(full[i - 2], SPEC[bits][3], wb)
                         + full[i - 7]
                         + _small(full[i - 15], SPEC[bits][2], wb)
                         + full[i - 16]) & mask)
        w = np.array(w0, dtype=dt)
        for i in range(16, rounds):
            fn(_ptr(w), i & 15)
            assert int(w[i & 15]) == full[i], (trial, i)


# -- whole messages in the kernel's order -------------------------------------

def _msgs(rng, lengths):
    return [rng.bytes(int(k)) for k in lengths]


def _fit(length, block_bytes):
    lenbytes = 16 if block_bytes == 128 else 8
    return (length + 1 + lenbytes + block_bytes - 1) // block_bytes


def _lengths_for(rng, count, block_bytes):
    """A seeded message length that pads to exactly `count` blocks."""
    lenbytes = 16 if block_bytes == 128 else 8
    lo = max(0, (count - 1) * block_bytes - lenbytes)
    hi = count * block_bytes - lenbytes - 1
    return int(rng.integers(lo, hi + 1))


def _cases(block_bytes, nmax, boundaries, seed):
    """{section: (first row, row count)}, the messages and their counts:
    the padding boundaries, rows of count 0, counts above B and below 0,
    one group of 32 (rows 32 k ..) whose counts run 0..B, and seeded
    random lengths over two ragged groups."""
    rng = np.random.default_rng(seed)
    msgs, counts, sections = [], [], {}

    def add(name, ms, cs):
        sections[name] = (len(msgs), len(ms))
        msgs.extend(ms)
        counts.extend(cs)

    ms = _msgs(rng, [k for k in boundaries for _ in range(8)])
    add("boundaries", ms, [_fit(len(m), block_bytes) for m in ms])
    ms = _msgs(rng, rng.integers(0, nmax * block_bytes - 17, 16))
    add("zero", ms, [0] * 16)
    ms = _msgs(rng, [_lengths_for(rng, nmax, block_bytes) for _ in range(8)]
               + [_lengths_for(rng, 1, block_bytes) for _ in range(8)])
    add("clamped", ms, [nmax + 1, nmax + 5, 1 << 30, 2 ** 31 - 1] * 2
        + [-1, -5, -(1 << 30), -2 ** 31] * 2)
    pad = (-len(msgs)) % 32                     # the mixed group on 32 k
    ms = _msgs(rng, rng.integers(0, block_bytes - 17, pad))
    add("filler", ms, [_fit(len(m), block_bytes) for m in ms])
    want = [lane % (nmax + 1) for lane in range(32)]
    ms = _msgs(rng, [_lengths_for(rng, max(c, 1), block_bytes)
                     for c in want])
    add("mixed", ms, want)
    ms = _msgs(rng, rng.integers(0, nmax * block_bytes - 17, 45))
    add("random", ms, [_fit(len(m), block_bytes) for m in ms])
    return sections, msgs, np.array(counts, dtype=np.int32)


SHA512_BOUNDARIES = (111, 112, 127, 128, 239, 240)
SHA256_BOUNDARIES = (55, 56, 63, 64)
SECTIONS = ("boundaries", "zero", "clamped", "mixed", "random")


def _expect(msgs, counts, nmax, block_bytes, lib_hash, init):
    """hashlib's digest where a row's clamped count is its message's own,
    the initial state where it is 0 (None elsewhere)."""
    out = []
    for m, c in zip(msgs, counts):
        c = min(max(int(c), 0), nmax)
        out.append(init if c == 0 else
                   lib_hash(m).digest() if c == _fit(len(m), block_bytes)
                   else None)
    return out


@pytest.fixture(scope="module")
def sha512_run(native):
    sections, msgs, counts = _cases(128, 3, SHA512_BOUNDARIES, 512)
    hi, lo, _ = (np.ascontiguousarray(a) for a in sha2.pad_sha512(msgs, 3))
    n = len(msgs)
    ohi = np.zeros((n, 8), dtype=np.uint32)
    olo = np.zeros((n, 8), dtype=np.uint32)
    native.h_sha512(_ptr(hi), _ptr(lo), _ptr(counts), n, 3, _ptr(ohi),
                    _ptr(olo))
    jhi, jlo = jax.jit(jsha2.sha512_blocks)(hi, lo, counts)
    got = [sha2.digest512_to_bytes(a, b) for a, b in zip(ohi, olo)]
    init = sha2.digest512_to_bytes([v >> 32 for v in sha2.H512],
                                   [v & M32 for v in sha2.H512])
    return (sections, (ohi, olo), (np.asarray(jhi), np.asarray(jlo)), got,
            _expect(msgs, counts, 3, 128, hashlib.sha512, init))


@pytest.fixture(scope="module")
def sha256_run(native):
    sections, msgs, counts = _cases(64, 2, SHA256_BOUNDARIES, 256)
    blocks = np.ascontiguousarray(sha2.pad_sha256(msgs, 2)[0])
    n = len(msgs)
    out = np.zeros((n, 8), dtype=np.uint32)
    native.h_sha256(_ptr(blocks), _ptr(counts), n, 2, _ptr(out))
    want = jax.jit(jsha2.sha256_blocks)(blocks, counts)
    got = [sha2.digest256_to_bytes(w) for w in out]
    init = sha2.digest256_to_bytes(sha2.H256)
    return (sections, (out,), (np.asarray(want),), got,
            _expect(msgs, counts, 2, 64, hashlib.sha256, init))


def _check(run, section):
    sections, words, jax_words, got, expect = run
    first, count = sections[section]
    rows = slice(first, first + count)
    for w, j in zip(words, jax_words):
        np.testing.assert_array_equal(w[rows], j[rows])
    checked = 0
    for i in range(first, first + count):
        if expect[i] is not None:
            assert got[i] == expect[i], (section, i)
            checked += 1
    return checked, count


@pytest.mark.parametrize("section", SECTIONS)
def test_sha512_kernel_order_matches_jax_and_hashlib(sha512_run, section):
    checked, count = _check(sha512_run, section)
    assert checked == count        # hashlib's digest or the initial state


@pytest.mark.parametrize("section", SECTIONS)
def test_sha256_kernel_order_matches_jax_and_hashlib(sha256_run, section):
    checked, count = _check(sha256_run, section)
    assert checked == count


def test_mixed_group_is_one_group_of_32(sha512_run, sha256_run):
    """The mixed counts sit in one group of 32 lanes, as a warp pair
    takes them, and run 0..B."""
    for run in (sha512_run, sha256_run):
        first, count = run[0]["mixed"]
        assert first % 32 == 0 and count == 32
