"""Kernel K14: the per-signature ZIP-215 program of reject localization,
and its plain torch version.

Replaces the body of `cometbft_tpu/ops/ed25519.py::verify_kernel` (:238)
after decompression: the 16-row cached table of -A, 64 4-bit Straus
windows MSB first (3 doublings without T, one with T, the B row of s's
nibble, the -A row of h's nibble), the add of -R, 3 cofactor doublings
and the identity test.  The JAX package runs it as one XLA program (a
lax.scan); eager torch runs it as ~10^5 small launches at 16,384
signatures.  ops/csrc/ed25519_persig.cu runs it in one launch on a
native field (fe25519_n.cuh: eight 32-bit words), in the plain version's
order, so its accumulators equal the plain version's as field elements
(frozen, coordinate for coordinate).  A quad of threads holds a
signature's accumulator, one coordinate a thread, and the B table and
each signature's -A table live in shared memory.

What bounds it on the H100: integer multiply-adds, 3,037 field products
a signature (195,730 multiply-adds on the native field's 8 x 8
schoolbook and fold), against 770 bytes in and one out; a quad's chain
of ~820 product rounds in series is the latency floor at any width.

`verify_ladder` runs the plain version for a CPU tensor and launches K14
for a CUDA tensor (or raises); `launches` counts the calls that launched.
"""

from __future__ import annotations

import torch

from . import device as devmod
from . import fe

PERSIG_THREADS = 64      # K14's threads per block: csrc PERSIG_THREADS
NL = fe.NLIMBS


def _ed():
    from . import ed25519
    return ed25519


def _lib():
    from . import _build

    lib = _build.load("ed25519_persig")
    if lib.ed25519_persig_threads() != PERSIG_THREADS:
        raise RuntimeError(f"ed25519_persig block size "
                           f"{lib.ed25519_persig_threads()} differs from "
                           "ops/cuda_persig.py")
    return lib


# ---------------------------------------------------------------------------
# the plain version, in K14's order
# ---------------------------------------------------------------------------

def neg_a_table_plain(a_pt: torch.Tensor) -> torch.Tensor:
    """(4, 20, N) points A -> (16, 4, 20, N) rows k (-A), k = 0..15, in
    cached form (Y+X, Y-X, 2dT, 2Z): the cached -A is the operand of the
    14 adds, and every row is converted once, as K14 builds them."""
    ed = _ed()
    neg_a = ed.point_neg(a_pt)
    cached = ed.to_cached(neg_a)
    rows = [ed.to_cached(ed.identity_point(a_pt.shape[2:], a_pt.device)),
            cached]
    cur = neg_a
    for _ in range(14):
        cur = ed.add_cached(cur, cached)
        rows.append(ed.to_cached(cur))
    return torch.stack(rows, dim=0)


def window_step_plain(acc, btab, neg_a_tab, s_nib, h_nib):
    """One window, acc <- 16 acc + s_nib B + h_nib (-A): 3 doublings
    without T, one with T, then the B row and the -A row.  btab
    (16, 4, 20, 1), neg_a_tab (16, 4, 20, N), nibbles (N,)."""
    ed = _ed()
    for _ in range(3):
        acc = ed.point_double(acc, with_t=False)
    acc = ed.point_double(acc, with_t=True)
    acc = ed.add_cached(acc, ed._select(btab, s_nib))
    return ed.add_cached(acc, ed._select(neg_a_tab, h_nib))


def ladder_plain(pts, s_limbs, h_limbs):
    """(4, 20, 2N) K1 points (A at lanes [0, N), R at [N, 2N)), (16, N)
    radix-2**16 limbs of s and h -> (4, 20, N) accumulators
    [8](sB - hA - R), before the identity test."""
    ed = _ed()
    n = s_limbs.shape[-1]
    a_pt, r_pt = pts[..., :n], pts[..., n:]
    neg_a_tab = neg_a_table_plain(a_pt)
    btab = devmod.constant(ed._BTAB_NP, pts.device, torch.int32)[..., None]
    s_nib, h_nib = ed._nibbles(s_limbs), ed._nibbles(h_limbs)
    acc = ed.identity_point((n,), pts.device)
    for i in range(s_nib.shape[0] - 1, -1, -1):
        acc = window_step_plain(acc, btab, neg_a_tab, s_nib[i], h_nib[i])
    acc = ed.add_cached(acc, ed.to_cached(ed.point_neg(r_pt)))
    for _ in range(3):               # cofactor 8
        acc = ed.point_double(acc, with_t=False)
    return acc


def verify_ladder_plain(pts, oks, s_limbs, h_limbs, return_acc=False):
    """(N,) bool verdicts ok_A & ok_R & ([8](sB - hA - R) == identity);
    with return_acc, (verdicts, the (4, 20, N) accumulators)."""
    n = s_limbs.shape[-1]
    acc = ladder_plain(pts, s_limbs, h_limbs)
    verdict = oks[:n] & oks[n:] & _ed().point_is_identity(acc)
    return (verdict, acc) if return_acc else verdict


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def verify_ladder(pts, oks, s_limbs, h_limbs, return_acc=False):
    """K1's (4, 20, 2N) int32 points and (2N,) bool ok flags of A || R,
    (16, N) int32 limbs of s and h -> (N,) bool verdicts (with
    return_acc, also the (4, 20, N) accumulators before the identity
    test: the kernel's frozen to canonical digits, the plain version's
    weak).  CPU tensor: the plain version; CUDA tensor: kernel K14."""
    if not pts.is_cuda:
        return verify_ladder_plain(pts, oks, s_limbs, h_limbs, return_acc)
    devmod.require(s_limbs, "verify_ladder s limbs", torch.int32, (16, None))
    n = s_limbs.shape[-1]
    dev = pts.device
    for t, name, dtype, shape in (
            (pts, "points", torch.int32, (4, NL, 2 * n)),
            (oks, "ok flags", torch.bool, (2 * n,)),
            (h_limbs, "h limbs", torch.int32, (16, n))):
        devmod.require(t, f"verify_ladder {name}", dtype, shape)
    for t in (oks, s_limbs, h_limbs):
        if t.device != dev:
            raise ValueError(f"verify_ladder: expected every input on {dev}, "
                             f"got {t.device}")
    pts, oks, s_limbs, h_limbs = (t.contiguous()
                                  for t in (pts, oks, s_limbs, h_limbs))
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    acc = (torch.empty((4, NL, n), dtype=torch.int32, device=dev)
           if return_acc else None)
    if n == 0:
        return (out, acc) if return_acc else out
    lib = _lib()
    btab = devmod.constant(_ed()._BTAB_NP, dev, torch.int32)
    with torch.cuda.device(dev):
        rc = lib.ed25519_verify_ladder(
            *(devmod.ptr(t) for t in (pts, oks, s_limbs, h_limbs, btab)),
            n, devmod.ptr(out), devmod.ptr(acc) if return_acc else None,
            devmod.stream(pts))
    devmod.check_launch(rc, "ed25519_verify_ladder")
    devmod.count_launch(verify_ladder)
    return (out, acc) if return_acc else out


verify_ladder.launches = 0
