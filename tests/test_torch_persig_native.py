"""K14 on the native field (cometbft_tpu_torch/ops/csrc/fe25519_n.cuh,
GF(2^255 - 19) in eight 32-bit words) and the localization's launch
width, on the CPU.

The header's constants against Python integers; its arithmetic compiled
for the host with g++ (skipped without g++) against Python integers at
seeded and edge values, K1's weak and negative limbs included; the
JAX-layout reads and writes (from_limbs / to_limbs) against ops/fe.py's
frozen values.  Then the route:
on one device crypto/batch._device_verify and _device_verify_hash pack
and launch K1 + K14 over the n live signatures, not over the bucket, and
their verdicts on a window with one bad signature and on a hostile batch
equal the bucket route's, ed25519_ref's and the JAX package's
per-signature program (its packer and jitted verify_kernel at bucket 16,
as its own tests run it).  Exact comparisons throughout."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import ed25519_ref as jref
from cometbft_tpu.ops import ed25519 as jdev
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import ed25519_ref as tref
from cometbft_tpu_torch.ops import cuda_decompress, cuda_persig
from cometbft_tpu_torch.ops import ed25519 as tdev
from cometbft_tpu_torch.ops import fe as tfe
from cometbft_tpu_torch.ops import sharding

torch.set_num_threads(1)

P = tfe.P
TOP = 1 << 256
CSRC = Path(tfe.__file__).parent / "csrc"
CPU = torch.device("cpu")


# -- the header ---------------------------------------------------------------

def _constants(name):
    src = (CSRC / name).read_text()
    return {m.group(1): int(m.group(2).rstrip("u"), 0) for m in re.finditer(
        r"\b([A-Z][A-Z0-9_]*)\s*=?\s*(0x[0-9A-Fa-f]+u?|\d+u?)\b", src)}


def _joined(c, prefix):
    return sum(c[f"{prefix}{i}"] << (32 * i) for i in range(8))


def test_native_header_constants():
    c = _constants("fe25519_n.cuh")
    assert c["NW"] * 32 == 256 and c["NL"] == tfe.NLIMBS
    assert c["RADIX"] == tfe.RADIX
    assert c["FOLD"] == TOP % P == 38
    words = [c["P_W0"]] + [c["P_WMID"]] * 6 + [c["P_W7"]]
    assert sum(w << (32 * i) for i, w in enumerate(words)) == P
    assert _joined(c, "D_W") == tfe.D_INT
    assert _joined(c, "D2_W") == tfe.D2_INT


def test_kernel_block_mirrors_the_wrapper():
    """ed25519_persig.cu's block size is the wrapper's, a whole number
    of quads (a signature each)."""
    c = _constants("ed25519_persig.cu")
    assert c["PERSIG_THREADS"] == cuda_persig.PERSIG_THREADS
    assert cuda_persig.PERSIG_THREADS % 4 == 0


_HARNESS = r"""
#define __device__
#define __forceinline__ inline
#define __noinline__
#include "fe25519_n.cuh"
using namespace fe25519n;
static fe ld(const uint32_t* p) { fe r; for (int i = 0; i < 8; ++i) r.w[i] = p[i]; return r; }
static void st(uint32_t* p, const fe& a) { for (int i = 0; i < 8; ++i) p[i] = a.w[i]; }
extern "C" {
void h_mul(const uint32_t* a, const uint32_t* b, uint32_t* o) { st(o, mul(ld(a), ld(b))); }
void h_sqr(const uint32_t* a, uint32_t* o) { st(o, sqr(ld(a))); }
void h_add(const uint32_t* a, const uint32_t* b, uint32_t* o) { st(o, add(ld(a), ld(b))); }
void h_sub(const uint32_t* a, const uint32_t* b, uint32_t* o) { st(o, sub(ld(a), ld(b))); }
void h_neg(const uint32_t* a, uint32_t* o) { st(o, neg(ld(a))); }
void h_freeze(const uint32_t* a, uint32_t* o) { st(o, freeze(ld(a))); }
int h_is_zero(const uint32_t* a) { return is_zero(ld(a)); }
int h_eq(const uint32_t* a, const uint32_t* b) { return eq(ld(a), ld(b)); }
void h_from_limbs(const int32_t* l, uint32_t* o) { st(o, from_limbs(l, 1)); }
void h_to_limbs(const uint32_t* a, int32_t* l) { to_limbs(l, 1, ld(a)); }
}
"""


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """fe25519_n.cuh compiled as host C++ behind a C interface."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the header for the host")
    d = tmp_path_factory.mktemp("fe25519_n")
    (d / "harness.cpp").write_text(_HARNESS)
    so = d / "libharness.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(CSRC),
                    str(d / "harness.cpp"), "-o", str(so)], check=True)
    return ctypes.CDLL(str(so))


def _words(x):
    return (ctypes.c_uint32 * 8)(*[(x >> (32 * i)) & 0xFFFFFFFF
                                   for i in range(8)])


def _value(a):
    return sum(int(a[i]) << (32 * i) for i in range(8))


EDGES = [0, 1, 2, 19, 38, P - 1, P, P + 1, P + 18, P + 19, (1 << 255) - 1,
         1 << 255, 2 * P - 1, 2 * P, 2 * P + 37, TOP - 39, TOP - 38,
         TOP - 2, TOP - 1, (1 << 32) - 1, (1 << 64) - 1, TOP - (1 << 38)]


def _values(seed):
    rng = np.random.default_rng(seed)
    vals = list(EDGES)
    vals += [int.from_bytes(rng.bytes(32), "little") for _ in range(300)]
    vals += [TOP - int(rng.integers(1 << 40)) for _ in range(40)]
    vals += [int(rng.integers(1 << 40)) for _ in range(40)]
    return vals


def _pairs(seed):
    vals = _values(seed)
    pairs = [(a, b) for a in EDGES for b in EDGES]
    pairs += [(a, vals[(7 * k + 3) % len(vals)]) for k, a in enumerate(vals)]
    return pairs


@pytest.mark.parametrize("op", ["mul", "add", "sub", "eq"])
def test_native_binary_ops_on_the_host(native, op):
    """Every binary operation keeps its result in [0, 2**256) and equals
    Python's value mod p, on every pair of edge values (0, p - 1, p,
    2**255 - 1, 2**256 - 1, ...) and on seeded pairs."""
    out = (ctypes.c_uint32 * 8)()
    for a, b in _pairs(17):
        if op == "eq":
            assert native.h_eq(_words(a), _words(b)) == ((a - b) % P == 0)
            continue
        getattr(native, f"h_{op}")(_words(a), _words(b), out)
        want = {"mul": a * b, "add": a + b, "sub": a - b}[op]
        assert _value(out) < TOP and _value(out) % P == want % P, \
            (op, hex(a), hex(b))


@pytest.mark.parametrize("op", ["sqr", "neg", "freeze", "is_zero"])
def test_native_unary_ops_on_the_host(native, op):
    """sqr and neg stay in [0, 2**256) at Python's value mod p; freeze
    gives the canonical value; is_zero decides a value mod p."""
    out = (ctypes.c_uint32 * 8)()
    for a in _values(23):
        if op == "is_zero":
            assert native.h_is_zero(_words(a)) == (a % P == 0), hex(a)
            continue
        getattr(native, f"h_{op}")(_words(a), out)
        if op == "freeze":
            assert _value(out) == a % P, hex(a)
        else:
            want = a * a if op == "sqr" else -a
            assert _value(out) < TOP and _value(out) % P == want % P, hex(a)


# K1 emits weak limbs in [-1220, 9800] (fe25519.cuh), and mul accepts
# |limb| <= 10300; canonical digits, and wider signed limbs, too
LIMB_RANGES = {"weak": (-1220, 9801), "mul_bound": (-10300, 10301),
               "canonical": (0, 8192), "wide": (-(1 << 20), 1 << 20)}


@pytest.mark.parametrize("kind", sorted(LIMB_RANGES))
def test_from_limbs_reads_signed_limbs(native, kind):
    """from_limbs reads 20 signed radix-2**13 limbs to [0, 2**256) at
    their value mod p, and to_limbs writes ops/fe.py's frozen digits of
    the same limbs (a round trip through the native words)."""
    rng = np.random.default_rng(31 + len(kind))
    lo, hi = LIMB_RANGES[kind]
    limbs = rng.integers(lo, hi, size=(300, tfe.NLIMBS)).astype(np.int32)
    limbs[0] = lo
    limbs[1] = hi - 1
    limbs[2] = 0
    frozen = tfe.freeze(torch.from_numpy(limbs.T.copy())).T.numpy() \
        if kind != "wide" else None
    out = (ctypes.c_uint32 * 8)()
    digits = (ctypes.c_int32 * tfe.NLIMBS)()
    for k, row in enumerate(limbs):
        native.h_from_limbs((ctypes.c_int32 * tfe.NLIMBS)(*row.tolist()), out)
        want = sum(int(v) << (13 * i) for i, v in enumerate(row)) % P
        assert _value(out) < TOP and _value(out) % P == want
        native.h_to_limbs(out, digits)
        assert list(digits) == tfe.int_to_limbs(want).tolist()
        if frozen is not None:
            assert list(digits) == frozen[k].tolist()


def test_from_limbs_reads_k1_points(native):
    """K1's own output (its plain version on random and hostile
    encodings, weak limbs) reads to the coordinates' values, and
    to_limbs gives ops/fe.py's frozen digits coordinate for
    coordinate."""
    rng = np.random.default_rng(5)
    encs = [rng.bytes(32) for _ in range(40)]
    encs += [(jref.P + 3).to_bytes(32, "little"),
             (jref.P + 1).to_bytes(32, "little"),
             jref.point_compress(jref.B)]
    words = np.stack([np.frombuffer(e, dtype=np.uint32) for e in encs], 1)
    pts, _ = cuda_decompress.decompress_plain(
        convert.words_from_numpy(words, "cpu"))
    frozen = tfe.freeze(pts.movedim(-2, 0)).movedim(0, -2)
    out = (ctypes.c_uint32 * 8)()
    digits = (ctypes.c_int32 * tfe.NLIMBS)()
    for c in range(4):
        for lane in range(pts.shape[-1]):
            row = pts[c, :, lane].tolist()
            native.h_from_limbs((ctypes.c_int32 * tfe.NLIMBS)(*row), out)
            assert _value(out) % P == tfe.limbs_to_int(row)
            native.h_to_limbs(out, digits)
            assert list(digits) == frozen[c, :, lane].tolist()


# -- the localization's launch width -------------------------------------------

def _signed(n, tag, n_keys=4):
    seeds = [bytes([60 + k]) * 32 for k in range(n_keys)]
    pks, msgs, sigs = [], [], []
    for i in range(n):
        seed = seeds[i % n_keys]
        msg = tag + b" %d" % i
        pks.append(tref.pubkey_from_seed(seed))
        msgs.append(msg)
        sigs.append(tref.sign(seed, msg))
    return pks, msgs, sigs


def _window_one_bad():
    """13 votes of a small window, one signature tampered."""
    pks, msgs, sigs = _signed(13, b"window vote")
    s = bytearray(sigs[9])
    s[40] ^= 0x01
    sigs[9] = bytes(s)
    return pks, msgs, sigs


def _hostile():
    """11 signatures: s >= L, a key with y = p + 3 under a junk
    signature, a tampered signature, and a valid signature under the
    non-canonical encoding y = p + 1 of the identity (R = sB)."""
    pks, msgs, sigs = _signed(11, b"hostile")
    sigs[1] = sigs[1][:32] + (tref.L + 7).to_bytes(32, "little")
    pks[3] = (tref.P + 3).to_bytes(32, "little")
    t = bytearray(sigs[5])
    t[50] ^= 0x08
    sigs[5] = bytes(t)
    k = 987654321
    pks[8] = (tref.P + 1).to_bytes(32, "little")
    sigs[8] = tref.point_compress(tref.point_mul(k, tref.B)) + \
        k.to_bytes(32, "little")
    return pks, msgs, sigs


CASES = {"window_one_bad": (_window_one_bad, [9]),
         "hostile_batch": (_hostile, [1, 3, 5])}


@pytest.fixture
def width_spy(monkeypatch):
    """The width each packer was asked for and each per-signature
    program ran at."""
    seen = {"pack": [], "persig": []}
    pack, pack_hash = ted.pack_batch, ted.pack_batch_device_hash
    persig = tdev.verify_kernel

    def pack_spy(pks, msgs, sigs, batch_size, **kw):
        seen["pack"].append(batch_size)
        return pack(pks, msgs, sigs, batch_size, **kw)

    def pack_hash_spy(pks, msgs, sigs, batch_size, **kw):
        seen["pack"].append(batch_size)
        return pack_hash(pks, msgs, sigs, batch_size, **kw)

    def persig_spy(*args):
        seen["persig"].append(int(args[0].shape[-1]))
        return persig(*args)

    monkeypatch.setattr(ted, "pack_batch", pack_spy)
    monkeypatch.setattr(ted, "pack_batch_device_hash", pack_hash_spy)
    monkeypatch.setattr(tdev, "verify_kernel", persig_spy)
    return seen


def _bucket_route(items):
    """The per-signature program over the bucket, as before."""
    pks, msgs, sigs = items
    n = len(pks)
    a, r, s, h, valid = ted.pack_batch(pks, msgs, sigs, tdev.bucket_size(n))
    got = tdev.verify_kernel(*convert.batch_from_numpy(a, r, s, h, "cpu"))
    return (got.numpy() & valid)[:n].tolist()


def _jax_verdicts(items):
    """The JAX package's per-signature program as its own tests run it
    on the CPU: its packer at bucket 16, then the jitted verify_kernel
    (ops/ed25519.verify_batch_device), compiled once for both cases."""
    n = len(items[0])
    a, r, s, h, valid = jed.pack_batch(*items, jdev.bucket_size(n))
    return (np.asarray(jdev.verify_batch_device(a, r, s, h))
            & valid)[:n].tolist()


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_verify_localizes_over_the_live_lanes(case, width_spy):
    """On one device _device_verify packs and launches the per-signature
    program at width n (13 or 11), not bucket_size(n) = 16, and its
    verdicts equal the bucket route's, ed25519_ref's and the JAX
    package's."""
    make, bad = CASES[case]
    items = make()
    n = len(items[0])
    assert tdev.bucket_size(n) == 16 != n
    parsed = ted.parse_and_hash(*items)
    ok, got = tbatch._device_verify(items[0], parsed, CPU)
    assert width_spy == {"pack": [n], "persig": [n]}
    want = [tref.verify(*it) for it in zip(*items)]
    assert not ok and [i for i, v in enumerate(got) if not v] == bad
    assert got == want == _bucket_route(items)
    assert got == [jref.verify(*it) for it in zip(*items)]
    assert got == _jax_verdicts(items)


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_verify_hash_localizes_over_the_live_lanes(case, width_spy):
    """The device-hash route's localization packs and launches at width
    n too, with the host-hash route's verdicts."""
    make, bad = CASES[case]
    items = make()
    n = len(items[0])
    ok, got = tbatch._device_verify_hash(
        items[0], items[1], ted.parse_batch(items[0], items[2]), device="cpu")
    assert width_spy == {"pack": [n], "persig": [n]}
    assert not ok and [i for i, v in enumerate(got) if not v] == bad
    assert got == [tref.verify(*it) for it in zip(*items)]


def test_localization_width_keeps_the_split_bucket(monkeypatch):
    """One device: the live n.  Several (named, or every local card when
    the mesh is off): auto_bucket, whose shards the split needs."""
    for n in (1, 13, 150, 4848, 16385):
        assert sharding.localization_width(n, 1) == n
        for nd in (2, 3, 4):
            assert sharding.localization_width(n, nd) == \
                sharding.auto_bucket(n, nd)
    for cards, want in ((0, 4848), (1, 4848),
                        (4, sharding.auto_bucket(4848, 4))):
        monkeypatch.setattr(sharding, "device_count", lambda c=cards: c)
        assert sharding.localization_width(4848) == want
    assert sharding.auto_bucket(4848, 4) == 16384
