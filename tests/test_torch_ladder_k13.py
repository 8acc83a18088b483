"""K13's inversion-free epilogue (cometbft_tpu_torch/ops/csrc/
secp256k1_kernels.cu, `ladder_verdict` in fe_secp_n.cuh) against the JAX
package's Fermat epilogue (cometbft_tpu/ops/secp256k1.py::verify_kernel:
x = X / Z^2, compared with r and, where rn_valid, r + n).

The kernel decides X == r Z^2 or X == rn Z^2 with Z != 0, and with Z == 0
off infinity as the Fermat inverse of 0 (= 0) decides it: r == 0, or
rn == 0 with rn_valid.  A torch model of that decision is held against
the JAX expression, evaluated with the JAX package's own field functions,
and against Python integers, on the accumulators the plain ladder reaches
on the JAX package's packs (hostile lanes, the structural filler with
r = 0, the r + n slot, keys whose sums end with Z = 0 off infinity) and on
constructed ones (Z = 0 with X = 0 and X != 0, the weak zero p, r and rn
= 0 at the interface, a match in the r + n slot without rn_valid, weak
limbs); the plain ladder's verdicts with its epilogue swapped for the
model are verify_kernel_plain's; and the header's `ladder_verdict`,
built for the host, gives the integers' verdicts."""

import ctypes
import importlib.util
import re
import shutil
import subprocess
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import secp256k1 as jsk
from cometbft_tpu.ops import fe_secp as jfs
from cometbft_tpu_torch.crypto import secp256k1 as tsk
from cometbft_tpu_torch.ops import cuda_secp
from cometbft_tpu_torch.ops import fe_secp as tfs
from cometbft_tpu_torch.ops import secp256k1 as tdev

torch.set_num_threads(1)

P, N = tsk.P, tsk.N
CSRC = Path(tfs.__file__).parent / "csrc"
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)
_PRIVS = [tsk.PrivKey.generate(bytes([90 + i]) * 32) for i in range(4)]
N_LADDER = 16 + 8              # the pack's lanes, then the Z = 0 lanes


# -- the epilogue three ways ---------------------------------------------------

def _model(acc, inf, r, rn, rn_valid):
    """K13's decision on torch tensors: (3, 22, B) accumulator, (B,) bool
    infinity, (22, B) r and rn, (B,) bool rn_valid."""
    z2 = tfs.sqr(acc[2])
    at_z = tfs.eq(acc[0], tfs.mul(r, z2)) | (
        rn_valid & tfs.eq(acc[0], tfs.mul(rn, z2)))
    z_zero = (tfs.is_zero(r) | (rn_valid & tfs.is_zero(rn)))
    return ~inf & torch.where(tfs.is_zero(acc[2]), z_zero, at_z)


def _jax(acc, inf, r, rn, rn_valid):
    """The JAX package's epilogue expression (ops/secp256k1.py:217-222),
    jitted: eagerly, its Fermat scan takes seconds a call here."""
    x_aff = jfs.mul(acc[0], jfs.inv(jfs.sqr(acc[2])))
    eq_r = jfs.eq(x_aff, r)
    eq_rn = jfs.eq(x_aff, rn) & rn_valid
    return ~inf & (eq_r | eq_rn)


def _ints(acc, inf, r, rn, rn_valid):
    """The same on Python integers (pow(0, p - 2, p) = 0 as Fermat)."""
    out = []
    for i in range(acc.shape[-1]):
        x, z = (tfs.limbs_to_int(acc[c, :, i].numpy()) for c in (0, 2))
        x_aff = x * pow(z * z % P, P - 2, P) % P
        out.append(not bool(inf[i]) and (
            x_aff == tfs.limbs_to_int(r[:, i].numpy())
            or (bool(rn_valid[i])
                and x_aff == tfs.limbs_to_int(rn[:, i].numpy()))))
    return out


# -- accumulators --------------------------------------------------------------

def _packed():
    """The JAX package's pack_batch of 16: six hostile classes (r = 0,
    s >= n, high s, a key that fails to decompress, a tampered message,
    another key's signature), valid lanes, lane 8 with r in the r + n
    slot and rn_valid, lane 9 the same without rn_valid; then
    chip_smoke.py's 8 lanes whose sums end with Z = 0 off infinity."""
    pks, msgs, sigs = [], [], []
    for i in range(14):
        p = _PRIVS[i % 4]
        pks.append(p.pub_key().bytes())
        msgs.append(b"k13 epilogue %d" % i)
        sigs.append(p.sign(msgs[-1]))
    sigs[1] = b"\x00" * 32 + sigs[1][32:]
    sigs[2] = sigs[2][:32] + (N + 5).to_bytes(32, "big")
    s3 = int.from_bytes(sigs[3][32:], "big")
    sigs[3] = sigs[3][:32] + (N - s3).to_bytes(32, "big")
    pks[4] = b"\x02" + (P + 1).to_bytes(33, "big")[1:]
    msgs[5] = msgs[5] + b"!"
    pks[6] = pks[7]
    packed = [np.array(a) for a in jsk.pack_batch(pks, msgs, sigs, 16)]
    for lane, valid in ((8, True), (9, False)):
        x = tfs.limbs_to_int(packed[4][:, lane])
        packed[5][:, lane] = tfs.int_to_limbs(x)
        packed[4][:, lane] = tfs.int_to_limbs(x + 1)
        packed[6][lane] = valid
    zero_z, zero_z_want = smoke._ladder_zero_z_arrays()
    want = [True, False, False, False, False, False, False, True, True,
            False, True, True, True, True, False, False] + zero_z_want
    return [np.concatenate([a, z], -1)
            for a, z in zip(packed[:7], zero_z)], want


def _ladder():
    """The JAX package's pack through verify_kernel_plain, its last
    jadd_complete's output (the accumulator the epilogue reads) kept."""
    packed, want = _packed()
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in packed)
    seen = {}
    real = tdev.jadd_complete

    def keep(*a):
        seen["acc"] = real(*a)
        return seen["acc"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdev, "jadd_complete", keep)
        verdict = tdev.verify_kernel_plain(*args)
    acc, inf = seen["acc"]
    return {"acc": acc, "inf": inf, "r": args[4], "rn": args[5],
            "rn_valid": args[6], "verdict": verdict, "want": want}


def _constructed():
    """Accumulators built by hand, one case a lane (see the list)."""
    rng = np.random.default_rng(151)

    def rand():
        return int.from_bytes(rng.bytes(32), "big") % P

    weak = [rng.integers(-1800, 4901, tfs.NLIMBS).astype(np.int32)
            for _ in range(2)]
    z, r = rand(), rand()
    zw = tfs.limbs_to_int(weak[1])
    p_limbs = tfs._P_CANON
    lanes = [
        # (X, Z, r, rn, rn_valid, inf), ints or limbs
        (0, 0, 0, 5, False, False),            # Z = 0, X = 0: r = 0 accepts
        (0, 0, 5, 5, False, False),            # Z = 0, X = 0, r != 0
        (0, 0, 5, 0, True, False),             # Z = 0, rn = 0 with rn_valid
        (0, 0, 5, 0, False, False),            # ... without
        (7, 0, 0, 5, False, False),            # Z = 0, X != 0: r = 0 accepts
        (7, 0, 7, 7, True, False),             # Z = 0, X != 0, r = rn = X
        (0, p_limbs, 5, 5, False, False),      # Z = p (weak zero), X = 0
        (7, p_limbs, p_limbs, 5, False, False),  # Z = p, r = p (zero)
        (r * z * z, z, r, 5, False, False),    # X = r Z^2
        (r * z * z + 1, z, r, 5, False, False),
        (r * z * z, z, 5, r, True, False),     # X = rn Z^2, rn_valid
        (r * z * z, z, 5, r, False, False),    # ... without: a reject
        (0, z, p_limbs, 5, False, False),      # r = p at the interface
        (0, z, 5, 0, True, False),             # rn = 0 at the interface
        (r * z * z, z, r, r, True, True),      # at infinity
        (weak[0], weak[1], tfs.limbs_to_int(weak[0]) * pow(
            zw * zw, P - 2, P), 5, False, False),  # weak limbs, a match
    ]

    def limbs(v):
        return v if isinstance(v, np.ndarray) else tfs.int_to_limbs(v)
    acc = np.zeros((3, tfs.NLIMBS, len(lanes)), np.int32)
    cols = [np.zeros((tfs.NLIMBS, len(lanes)), np.int32) for _ in range(2)]
    for i, (x, zz, rr, rn, _, _) in enumerate(lanes):
        acc[0, :, i], acc[1, :, i], acc[2, :, i] = limbs(x), limbs(1), \
            limbs(zz)
        cols[0][:, i], cols[1][:, i] = limbs(rr), limbs(rn)
    return {"acc": torch.from_numpy(acc),
            "inf": torch.tensor([ln[5] for ln in lanes]),
            "r": torch.from_numpy(cols[0]), "rn": torch.from_numpy(cols[1]),
            "rn_valid": torch.tensor([ln[4] for ln in lanes])}


@pytest.fixture(scope="module")
def cases():
    """The ladder's and the constructed accumulators, each with the JAX
    expression's verdicts: XLA compiles the expression, once for both
    sets, in a thread while torch runs the plain ladder."""
    out = {"constructed": _constructed()}
    n = N_LADDER + out["constructed"]["acc"].shape[-1]
    specs = [jax.ShapeDtypeStruct(shape, dtype) for shape, dtype in (
        ((3, tfs.NLIMBS, n), jnp.int32), ((n,), jnp.bool_),
        ((tfs.NLIMBS, n), jnp.int32), ((tfs.NLIMBS, n), jnp.int32),
        ((n,), jnp.bool_))]
    compiled = {}
    worker = threading.Thread(target=lambda: compiled.update(
        fn=jax.jit(_jax).lower(*specs).compile()))
    worker.start()
    try:
        out["ladder"] = _ladder()
    finally:
        worker.join()
    joint = [np.concatenate([a.numpy() for a in pair], -1) for pair in zip(
        _epilogue_args(out["ladder"]), _epilogue_args(out["constructed"]))]
    verdicts = np.asarray(compiled["fn"](*joint)).tolist()
    out["ladder"]["jax"] = verdicts[:N_LADDER]
    out["constructed"]["jax"] = verdicts[N_LADDER:]
    return out


CONSTRUCTED_WANT = [True, False, True, False, True, False, False, True,
                    True, False, True, False, True, True, False, True]


def _epilogue_args(case):
    return tuple(case[k] for k in ("acc", "inf", "r", "rn", "rn_valid"))


# -- tests ---------------------------------------------------------------------

@pytest.mark.parametrize("which", ["ladder", "constructed"])
def test_epilogue_model_matches_jax_and_integers(which, cases):
    case = cases[which]
    args = _epilogue_args(case)
    got = _model(*args).tolist()
    assert got == case["jax"]
    assert got == _ints(*args)
    if which == "constructed":
        assert got == CONSTRUCTED_WANT
    else:
        # the Z = 0 lanes end off infinity with Z = 0 (X = 0 in 0-3)
        zero_z = tfs.is_zero(case["acc"][2, :, 16:])
        assert zero_z.all() and not case["inf"][16:].any()
        assert tfs.is_zero(case["acc"][0, :, 16:20]).all()
        assert not tfs.is_zero(case["acc"][0, :, 20:]).any()


def test_plain_ladder_with_the_model_epilogue_gives_plain_verdicts(cases):
    """verify_kernel_plain's loop with K13's epilogue in place of the
    Fermat one: the same verdicts, which are the host's on the signed
    lanes and chip_smoke.py's oracle on the Z = 0 lanes."""
    ladder = cases["ladder"]
    got = _model(*_epilogue_args(ladder))
    assert got.tolist() == ladder["verdict"].tolist() == ladder["want"]


_HARNESS = r"""
#define __device__
#define __forceinline__ inline
#define __noinline__
#include "fe_secp_n.cuh"
using namespace fesecpn;
extern "C" int h_verdict(const int32_t* x, const int32_t* z, const int32_t* r,
                         const int32_t* rn, int rn_valid, int inf) {
  const fe X = from_limbs(x, 1), Z = from_limbs(z, 1);
  const fe R = from_limbs(r, 1), RN = from_limbs(rn, 1);
  const fe z2 = sqr(Z);
  return ladder_verdict(X, Z, R, RN, mul(R, z2), mul(RN, z2), rn_valid != 0,
                        inf != 0);
}
"""


def test_header_ladder_verdict_on_the_host(tmp_path, cases):
    """fe_secp_n.cuh's ladder_verdict compiled as host C++, fed the JAX
    layout through from_limbs as the kernel is: the integers' verdicts on
    every accumulator above."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the header for the host")
    (tmp_path / "harness.cpp").write_text(_HARNESS)
    so = tmp_path / "libharness.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(CSRC),
                    str(tmp_path / "harness.cpp"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    ptr = ctypes.POINTER(ctypes.c_int32)
    lib.h_verdict.argtypes = [ptr] * 4 + [ctypes.c_int] * 2
    for case in cases.values():
        args = _epilogue_args(case)
        got = []
        for i in range(case["acc"].shape[-1]):
            cols = [np.ascontiguousarray(a.numpy()) for a in (
                case["acc"][0, :, i], case["acc"][2, :, i], case["r"][:, i],
                case["rn"][:, i])]
            got.append(bool(lib.h_verdict(
                *(c.ctypes.data_as(ptr) for c in cols),
                int(case["rn_valid"][i]), int(case["inf"][i]))))
        assert got == _ints(*args)


def test_wrapper_block_size_is_the_kernel_s():
    """ops/cuda_secp.SECP_THREADS, which the wrapper checks against the
    library's secp_threads() on the card, is the source's K13 block: a
    whole number of thread quads and of warps."""
    src = (CSRC / "secp256k1_kernels.cu").read_text()
    threads = int(re.search(r"#define SECP_THREADS (\d+)", src).group(1))
    assert threads == cuda_secp.SECP_THREADS
    assert threads % 32 == 0 and threads >= 64
