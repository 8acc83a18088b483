"""Kernels K11-K13 of the secp256k1 verify path — the per-key window
tables, the shared-table MSM verify and the Straus ladder — as ctypes
wrappers of ops/csrc/secp256k1_kernels.cu.

K11 `q_msm_tables` replaces `cometbft_tpu/ops/secp256k1.py::
q_msm_tables_kernel` (:327), K12 `msm_verify` its `msm_verify_kernel`
(:360) and K13 `verify_ladder` its `verify_kernel` (:186): plain `jnp`
under `lax.scan` in the JAX package, tens of thousands of small launches
each in eager torch.  K11 and K12 run on the native field of
ops/csrc/fe_secp_n.cuh (eight 32-bit words, operands in registers):
K11's point operations on thread quads, in two CUDA launches (a quad per
key walks its 52 window bases, then a quad per (window, key) builds the
window's 16 odd rows), its tables stored frozen, equal to the plain
version's at canonical value; K12 splits each signature's sum over 4 or
8 threads with blinded partial sums, its verdicts the plain version's.
K13 runs on the same field and on thread quads, a quad per signature
(its Q table and the G table in shared memory, an inversion-free
epilogue), its verdicts the plain version's.  Bound on the H100:
operations (field products), reached by none of them.

Every wrapper runs its plain version (ops/secp256k1.py, `*_plain`) for a
CPU tensor and launches its kernel for a CUDA tensor (or raises);
`launches` counts the calls that launched.  The static G tables reach the
card once per device (ops/secp256k1.g_tables_on).
"""

from __future__ import annotations

import torch

from . import device as devmod
from . import fe_secp as fs

SECP_THREADS = 64        # K13's threads per block: csrc SECP_THREADS
NL = fs.NLIMBS


def _secp():
    from . import secp256k1
    return secp256k1


def _lib():
    from . import _build

    lib = _build.load("secp256k1_kernels")
    if lib.secp_threads() != SECP_THREADS:
        raise RuntimeError(f"secp256k1_kernels block size "
                           f"{lib.secp_threads()} differs from "
                           "ops/cuda_secp.py")
    return lib


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    devmod.require(t, name, dtype, shape)
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")


# ---------------------------------------------------------------------------
# K11: per-key odd-multiple window tables
# ---------------------------------------------------------------------------

def q_msm_tables(qx: torch.Tensor, qy: torch.Tensor):
    """(22, K) int32 affine keys -> ((52, 16, 3, 22, K), (3, 22, K))."""
    if not qx.is_cuda:
        return _secp().q_msm_tables_kernel_plain(qx, qy)
    sk = _secp()
    _require(qx, "q tables qx", torch.int32, (NL, None), qx.device)
    nk = qx.shape[-1]
    _require(qy, "q tables qy", torch.int32, (NL, nk), qx.device)
    if nk == 0:
        raise ValueError("q tables: no keys")
    bases = torch.empty((sk.MSM_NQ, 3, NL, nk), dtype=torch.int32,
                        device=qx.device)
    qtab = torch.empty((sk.MSM_NQ, 16, 3, NL, nk), dtype=torch.int32,
                       device=qx.device)
    corr = torch.empty((3, NL, nk), dtype=torch.int32, device=qx.device)
    lib = _lib()
    with torch.cuda.device(qx.device):
        rc = lib.secp_q_tables(devmod.ptr(qx), devmod.ptr(qy), nk,
                               devmod.ptr(bases), devmod.ptr(qtab),
                               devmod.ptr(corr), devmod.stream(qx))
    devmod.check_launch(rc, "secp_q_tables")
    devmod.count_launch(q_msm_tables)
    return qtab, corr


q_msm_tables.launches = 0


# ---------------------------------------------------------------------------
# K12: the shared-table MSM verify
# ---------------------------------------------------------------------------

def msm_verify(qtab, q_corr, gid, g_rows, g_neg, q_rows, q_neg, r_limbs,
               rn_limbs, rn_valid, s_pt):
    """See ops/secp256k1.msm_verify_kernel; (B,) bool verdicts."""
    if not gid.is_cuda:
        return _secp().msm_verify_kernel_plain(
            qtab, q_corr, gid, g_rows, g_neg, q_rows, q_neg, r_limbs,
            rn_limbs, rn_valid, s_pt)
    sk = _secp()
    dev = gid.device
    nb = gid.shape[0]
    nk = qtab.shape[-1]
    for t, name, dtype, shape in (
            (qtab, "qtab", torch.int32, (sk.MSM_NQ, 16, 3, NL, None)),
            (q_corr, "q_corr", torch.int32, (3, NL, nk)),
            (gid, "gid", torch.int32, (nb,)),
            (g_rows, "g_rows", torch.int32, (sk.MSM_NG, nb)),
            (g_neg, "g_neg", torch.bool, (sk.MSM_NG, nb)),
            (q_rows, "q_rows", torch.int32, (sk.MSM_NQ, nb)),
            (q_neg, "q_neg", torch.bool, (sk.MSM_NQ, nb)),
            (r_limbs, "r_limbs", torch.int32, (NL, nb)),
            (rn_limbs, "rn_limbs", torch.int32, (NL, nb)),
            (rn_valid, "rn_valid", torch.bool, (nb,)),
            (s_pt, "s_pt", torch.int32, (3, NL))):
        _require(t, f"msm_verify {name}", dtype, shape, dev)
    if nk == 0:
        raise ValueError("msm_verify: no key tables")
    gtab, gcorr, _ = _secp().g_tables_on(dev)
    out = torch.empty((nb,), dtype=torch.bool, device=dev)
    if nb == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.secp_msm_verify(*(devmod.ptr(t) for t in (
            qtab, q_corr, gid, g_rows, g_neg, q_rows, q_neg, r_limbs,
            rn_limbs, rn_valid, s_pt, gtab, gcorr)), nb, nk, devmod.ptr(out),
            devmod.stream(gid))
    devmod.check_launch(rc, "secp_msm_verify")
    devmod.count_launch(msm_verify)
    return out


msm_verify.launches = 0


# ---------------------------------------------------------------------------
# K13: the per-signature Straus ladder
# ---------------------------------------------------------------------------

def verify_ladder(qx, qy, u1_nibs, u2_nibs, r_limbs, rn_limbs, rn_valid):
    """See ops/secp256k1.verify_kernel; (B,) bool verdicts."""
    if not qx.is_cuda:
        return _secp().verify_kernel_plain(qx, qy, u1_nibs, u2_nibs, r_limbs,
                                           rn_limbs, rn_valid)
    dev = qx.device
    nb = qx.shape[-1]
    for t, name, dtype, shape in (
            (qx, "qx", torch.int32, (NL, nb)),
            (qy, "qy", torch.int32, (NL, nb)),
            (u1_nibs, "u1_nibs", torch.int32, (64, nb)),
            (u2_nibs, "u2_nibs", torch.int32, (64, nb)),
            (r_limbs, "r_limbs", torch.int32, (NL, nb)),
            (rn_limbs, "rn_limbs", torch.int32, (NL, nb)),
            (rn_valid, "rn_valid", torch.bool, (nb,))):
        _require(t, f"ladder {name}", dtype, shape, dev)
    gtab = _secp().g_tables_on(dev)[2]
    out = torch.empty((nb,), dtype=torch.bool, device=dev)
    if nb == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.secp_ladder(*(devmod.ptr(t) for t in (
            qx, qy, u1_nibs, u2_nibs, r_limbs, rn_limbs, rn_valid, gtab)),
            nb, devmod.ptr(out), devmod.stream(qx))
    devmod.check_launch(rc, "secp_ladder")
    devmod.count_launch(verify_ladder)
    return out


verify_ladder.launches = 0
