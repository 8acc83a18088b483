"""Batched secp256k1 ECDSA verification on torch tensors: Jacobian point
arithmetic, the per-signature Straus ladder (K13), the per-key window
tables (K11) and the shared-table MSM verify (K12) — the port's
counterpart of `cometbft_tpu.ops.secp256k1`.

Layout is the JAX package's: field elements (22, B) int32 (ops/fe_secp),
Jacobian points (3, 22, B) with an explicit boolean infinity plane where
the formulas are incomplete, the batch axis minor.  The host computes
e = SHA-256(msg), w = s^-1 mod n, u1 = e*w, u2 = r*w and decompresses the
key (crypto/secp256k1.py); the device checks x(u1*G + u2*Q) == r (mod n).

Two programs, chosen by crypto/secp256k1.msm_enabled():
- the MSM program (default): per-key odd-multiple window tables
  (q_msm_tables_kernel, K11; cached across commits by
  crypto/secp256k1.QTableCache), then msm_verify_kernel (K12): u1*G from
  a static affine G table and u2*Q from the key's table with no in-loop
  doubling, the accumulator blinded by a host-random point S, and an
  inversion-free epilogue;
- the ladder (COMETBFT_TPU_SECP_MSM=0): verify_kernel (K13), 64 windows
  of 4 doublings and two exact additions over a static 16-row G table and
  a per-signature 16-row Q table, then x = X / Z^2 by Fermat (the kernel
  decides the same comparison as X == r Z^2, without the inverse).

The JAX package computes all three as plain `jnp` under `lax.scan`.  In
eager torch each would be tens of thousands of small launches, so on a
CUDA tensor each runs its hand-written kernel (ops/cuda_secp.py,
ops/csrc/secp256k1_kernels.cu); on a CPU tensor it runs the plain version
below, which K11 equals at canonical value (it stores frozen tables)
and K12 and K13 verdict for verdict.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_secp
from . import device as devmod
from . import fe_secp as fs
from . import msm

# secp256k1 group order and generator
N_ORDER = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

_X, _Y, _Z = 0, 1, 2

# the MSM program's windows: u1 in 8-bit odd windows over 2**257, u2 in
# 5-bit odd windows over 2**261 (Joye-Tunstall recode, ops/msm.recode_jt)
MSM_WG, MSM_NG = 8, 32
MSM_WQ, MSM_NQ = 5, 52


def _pt(x, y, z):
    return torch.stack([x, y, z], dim=0)


def _one_fe(batch_shape, device):
    return fs.broadcast(fs.ONE_LIMBS, batch_shape, device)


def _zero_fe(batch_shape, device):
    return torch.zeros((fs.NLIMBS,) + tuple(batch_shape), dtype=torch.int32,
                       device=device)


# ---------------------------------------------------------------------------
# Jacobian point arithmetic (a = 0)
# ---------------------------------------------------------------------------

def jdbl(p):
    """dbl-2009-l for a = 0; Z = 0 stays Z = 0 (no 2-torsion)."""
    x, y, z = p[_X], p[_Y], p[_Z]
    a = fs.sqr(x)
    b = fs.sqr(y)
    c = fs.sqr(b)
    d = fs.sub(fs.sub(fs.sqr(fs.add(x, b)), a), c)
    d = fs.add(d, d)
    e = fs.add(fs.add(a, a), a)
    f = fs.sqr(e)
    x3 = fs.sub(f, fs.add(d, d))
    c8 = fs.add(c, c)
    c8 = fs.add(c8, c8)
    c8 = fs.add(c8, c8)
    y3 = fs.sub(fs.mul(e, fs.sub(d, x3)), c8)
    z3 = fs.mul(y, z)
    z3 = fs.add(z3, z3)
    return _pt(x3, y3, z3)


def _jadd_core(p, q):
    """add-2007-bl; undefined for p == +-q or infinities (callers select
    around those).  Returns (sum, h, r)."""
    z1z1 = fs.sqr(p[_Z])
    z2z2 = fs.sqr(q[_Z])
    u1 = fs.mul(p[_X], z2z2)
    u2 = fs.mul(q[_X], z1z1)
    s1 = fs.mul(fs.mul(p[_Y], q[_Z]), z2z2)
    s2 = fs.mul(fs.mul(q[_Y], p[_Z]), z1z1)
    h = fs.sub(u2, u1)
    rr = fs.sub(s2, s1)
    h2 = fs.sqr(h)
    h3 = fs.mul(h, h2)
    v = fs.mul(u1, h2)
    x3 = fs.sub(fs.sub(fs.sqr(rr), h3), fs.add(v, v))
    y3 = fs.sub(fs.mul(rr, fs.sub(v, x3)), fs.mul(s1, h3))
    z3 = fs.mul(fs.mul(p[_Z], q[_Z]), h)
    return _pt(x3, y3, z3), h, rr


def jadd_fast(p, q):
    """Addition of structurally distinct nonzero points."""
    return _jadd_core(p, q)[0]


def jadd_complete(p, p_inf, q, q_inf):
    """Exact addition: p or q at infinity, p == q (doubling) and p == -q
    (infinity) selected among computed branches, with canonical
    zero-tests — u1, u2 and Q are adversarial in verification."""
    added, h, rr = _jadd_core(p, q)
    doubled = jdbl(p)
    h_zero = fs.is_zero(h)
    r_zero = fs.is_zero(rr)
    is_dbl = h_zero & r_zero & ~p_inf & ~q_inf
    is_cancel = h_zero & ~r_zero & ~p_inf & ~q_inf
    out = torch.where(is_dbl[None, None], doubled, added)
    out = torch.where(p_inf[None, None], q, out)
    out = torch.where(q_inf[None, None], p, out)
    out_inf = (p_inf & q_inf) | is_cancel
    one = _one_fe(out.shape[2:], out.device)
    out = torch.where(is_cancel[None, None], _pt(one, one, one), out)
    return out, out_inf


def jadd_mixed(p, ax, ay):
    """madd-2007-bl (Z2 = 1): Jacobian p + affine (ax, ay); incomplete
    (the MSM program's blinded accumulator keeps it off the collisions)."""
    z1z1 = fs.sqr(p[_Z])
    u2 = fs.mul(ax, z1z1)
    s2 = fs.mul(fs.mul(ay, p[_Z]), z1z1)
    h = fs.sub(u2, p[_X])
    hh = fs.sqr(h)
    i4 = fs.add(fs.add(hh, hh), fs.add(hh, hh))
    j = fs.mul(h, i4)
    rr = fs.sub(s2, p[_Y])
    rr = fs.add(rr, rr)
    v = fs.mul(p[_X], i4)
    x3 = fs.sub(fs.sub(fs.sqr(rr), j), fs.add(v, v))
    y1j = fs.mul(p[_Y], j)
    y3 = fs.sub(fs.mul(rr, fs.sub(v, x3)), fs.add(y1j, y1j))
    z3 = fs.sub(fs.sub(fs.sqr(fs.add(p[_Z], h)), z1z1), hh)
    return _pt(x3, y3, z3)


# ---------------------------------------------------------------------------
# static G tables, built on the host once per process
# ---------------------------------------------------------------------------

def _g_table_np() -> np.ndarray:
    """(16, 3, 22) affine rows k*G (Z = 1), row 0 a (1, 1, 1) filler (a
    zero nibble is handled by the infinity mask)."""
    from ..crypto import secp256k1 as host

    rows = np.zeros((16, 3, fs.NLIMBS), dtype=np.int32)
    rows[0, :] = fs.ONE_LIMBS
    for k in range(1, 16):
        x, y = host._jaffine(host._jmul(k, host._G))
        rows[k, 0] = fs.int_to_limbs(x)
        rows[k, 1] = fs.int_to_limbs(y)
        rows[k, 2] = fs.ONE_LIMBS
    return rows


def _g_msm_table_np():
    """((MSM_NG, 128, 2, 22) affine odd multiples (2m+1)*2**(8j)*G, (2, 22)
    the Joye-Tunstall correction point 2**256*G): ~4k affine
    conversions in Python integers."""
    from ..crypto import secp256k1 as host

    rows = np.zeros((MSM_NG, 1 << (MSM_WG - 1), 2, fs.NLIMBS), np.int32)
    for j in range(MSM_NG):
        base = host._jmul(1 << (MSM_WG * j), host._G)
        d2 = host._jdbl(base)
        cur = base
        for m in range(1 << (MSM_WG - 1)):
            x, y = host._jaffine(cur)
            rows[j, m, 0] = fs.int_to_limbs(x)
            rows[j, m, 1] = fs.int_to_limbs(y)
            cur = host._jadd(cur, d2)
    corr = np.zeros((2, fs.NLIMBS), np.int32)
    cx, cy = host._jaffine(host._jmul(1 << (MSM_WG * MSM_NG), host._G))
    corr[0] = fs.int_to_limbs(cx)
    corr[1] = fs.int_to_limbs(cy)
    return rows, corr


_G_TABLES: dict = {}


def g_table() -> np.ndarray:
    if "ladder" not in _G_TABLES:
        _G_TABLES["ladder"] = _g_table_np()
    return _G_TABLES["ladder"]


def g_msm_table():
    if "msm" not in _G_TABLES:
        _G_TABLES["msm"] = _g_msm_table_np()
    return _G_TABLES["msm"]


_G_ON: dict = {}


def g_tables_on(dev: torch.device):
    """(K12's G table, its correction point, K13's G table) as int32
    tensors on `dev`: copied there once (ops/device.constant), then
    looked up by device alone, without hashing 720 KB each call."""
    tabs = _G_ON.get(dev)
    if tabs is None:
        tabs = _G_ON[dev] = tuple(devmod.constant(a, dev, torch.int32)
                                  for a in (*g_msm_table(), g_table()))
    return tabs


# ---------------------------------------------------------------------------
# K13: the per-signature ladder
# ---------------------------------------------------------------------------

def _select(table, nib):
    """(16, 3, 22, ...) table + (...) nibbles -> (3, 22, ...): the JAX
    select cascade (a nibble outside 1..15 takes row 0)."""
    sel = table[0]
    cond = nib[None, None]
    for k in range(1, 16):
        sel = torch.where(cond == k, table[k], sel)
    return sel


def _q_table(qx, qy):
    """Per-signature rows k*Q, k = 0..15, Jacobian: row 0 a (1, 1, 1)
    filler, 2Q by doubling, then 13 adds of Q."""
    one = _one_fe(qx.shape[1:], qx.device)
    q1 = _pt(qx, qy, one)
    rows = [_pt(one, one, one), q1, jdbl(q1)]
    for _ in range(13):
        rows.append(jadd_fast(rows[-1], q1))
    return torch.stack(rows, dim=0)


def verify_kernel_plain(qx, qy, u1_nibs, u2_nibs, r_limbs, rn_limbs,
                        rn_valid):
    """K13's plain version: see verify_kernel."""
    batch = qx.shape[1:]
    dev = qx.device
    gtab = g_tables_on(dev)[2].reshape(
        (16, 3, fs.NLIMBS) + (1,) * len(batch))
    qtab = _q_table(qx, qy)
    acc = _pt(_one_fe(batch, dev), _one_fe(batch, dev), _zero_fe(batch, dev))
    acc_inf = torch.ones(batch, dtype=torch.bool, device=dev)
    for n1, n2 in zip(u1_nibs, u2_nibs):
        for _ in range(4):
            acc = jdbl(acc)
        acc, acc_inf = jadd_complete(acc, acc_inf, _select(gtab, n1), n1 == 0)
        acc, acc_inf = jadd_complete(acc, acc_inf, _select(qtab, n2), n2 == 0)
    z2 = fs.sqr(acc[_Z])
    x_aff = fs.mul(acc[_X], fs.inv(z2))
    eq_r = fs.eq(x_aff, r_limbs)
    eq_rn = fs.eq(x_aff, rn_limbs) & rn_valid
    return ~acc_inf & (eq_r | eq_rn)


def verify_kernel(qx, qy, u1_nibs, u2_nibs, r_limbs, rn_limbs, rn_valid):
    """Batched ECDSA verify by the Straus ladder.

    qx, qy: (22, B) affine key coordinates (host-decompressed);
    u1_nibs, u2_nibs: (64, B) int32 4-bit windows, MSB first; r_limbs:
    (22, B) r as a field element, rn_limbs (22, B) r + n with rn_valid
    (B,) marking r + n < p.  Returns (B,) bool: x(u1 G + u2 Q) == r
    (mod n) and not infinity.  CUDA tensors: kernel K13."""
    return cuda_secp.verify_ladder(qx, qy, u1_nibs, u2_nibs, r_limbs,
                                   rn_limbs, rn_valid)


# ---------------------------------------------------------------------------
# K11: per-key odd-multiple window tables
# ---------------------------------------------------------------------------

def q_window_bases_plain(qx, qy):
    """K11's first step: the (MSM_NQ, 3, 22, K) window bases 2**(5j)*Q and
    the (3, 22, K) correction point 2**260*Q, five doublings a window."""
    b = _pt(qx, qy, _one_fe(qx.shape[1:], qx.device))
    bases = []
    for _ in range(MSM_NQ):
        bases.append(b)
        for _ in range(MSM_WQ):
            b = jdbl(b)
    return torch.stack(bases, dim=0), b


def q_window_rows_plain(bases):
    """K11's second step, over every (window, key) at once: rows
    b, b + 2b, ..., b + 15*2b of each base b -> (MSM_NQ, 16, 3, 22, K)."""
    nwin, _, nl, k = bases.shape
    b = bases.permute(1, 2, 0, 3).reshape(3, nl, nwin * k)
    d2 = jdbl(b)
    rows = [b]
    for _ in range(15):
        rows.append(jadd_fast(rows[-1], d2))
    tab = torch.stack(rows, dim=0).reshape(16, 3, nl, nwin, k)
    return tab.permute(3, 0, 1, 2, 4).contiguous()


def q_msm_tables_kernel_plain(qx, qy):
    """K11's plain version: see q_msm_tables_kernel."""
    bases, corr = q_window_bases_plain(qx, qy)
    return q_window_rows_plain(bases), corr


def q_msm_tables_kernel(qx, qy):
    """(22, K) affine distinct keys -> per-key odd-multiple window tables
    ((MSM_NQ, 16, 3, 22, K) Jacobian: row m of window j is
    (2m+1)*2**(5j)*Q) and the (3, 22, K) correction points 2**260*Q.
    The row chain adds 2*2**(5j)*Q to odd multiples, so it never meets
    the exact-zero cases (cofactor 1).  CUDA tensors: kernel K11."""
    return cuda_secp.q_msm_tables(qx, qy)


# ---------------------------------------------------------------------------
# K12: the shared-table MSM verify
# ---------------------------------------------------------------------------

def msm_verify_kernel_plain(qtab, q_corr, gid, g_rows, g_neg, q_rows, q_neg,
                            r_limbs, rn_limbs, rn_valid, s_pt):
    """K12's plain version: see msm_verify_kernel."""
    dev = gid.device
    b = gid.shape[0]
    gtab, gc, _ = g_tables_on(dev)
    nk = qtab.shape[-1]
    slot = gid.long().clamp(0, nk - 1)
    s_b = s_pt[:, :, None].expand(3, fs.NLIMBS, b)

    def g_gather(tab_j, rows_j):
        return tab_j[rows_j.long().clamp(0, 127)].permute(1, 2, 0)

    def g_add(a, ent, neg):
        return jadd_mixed(a, ent[0], torch.where(neg[None], -ent[1], ent[1]))

    def q_gather(tab_j, rows_j):
        return tab_j[rows_j.long().clamp(0, 15), :, :, slot].permute(1, 2, 0)

    def q_add(a, ent, neg):
        y = torch.where(neg[None], -ent[1], ent[1])
        return jadd_fast(a, _pt(ent[0], y, ent[2]))

    acc = msm.multiprod_shared_tables(s_b, [
        (gtab, g_rows, g_neg, g_gather, g_add),
        (qtab, q_rows, q_neg, q_gather, q_add)])
    acc = jadd_mixed(acc, gc[0][:, None].expand(fs.NLIMBS, b),
                     gc[1][:, None].expand(fs.NLIMBS, b))
    acc = jadd_fast(acc, q_corr[:, :, slot])
    acc = jadd_fast(acc, _pt(s_b[_X], -s_b[_Y], s_b[_Z]))
    z2 = fs.sqr(acc[_Z])
    not_inf = ~fs.is_zero(acc[_Z])
    ok_r = fs.eq(acc[_X], fs.mul(r_limbs, z2))
    ok_rn = fs.eq(acc[_X], fs.mul(rn_limbs, z2)) & rn_valid
    return not_inf & (ok_r | ok_rn)


def msm_verify_kernel(qtab, q_corr, gid, g_rows, g_neg, q_rows, q_neg,
                      r_limbs, rn_limbs, rn_valid, s_pt):
    """Batched ECDSA verify by the shared-table multi-product.

    qtab (MSM_NQ, 16, 3, 22, K) and q_corr (3, 22, K): q_msm_tables_kernel
    of the batch's distinct keys; gid (B,) int32 key slot per signature;
    g_rows / g_neg (MSM_NG, B) int32 / bool odd-row indices and signs of
    the odd-normalized u1, q_rows / q_neg (MSM_NQ, B) those of u2;
    r_limbs, rn_limbs, rn_valid as in verify_kernel; s_pt (3, 22) the
    pack's blinding point S.  The accumulator starts at S, takes 32 mixed
    adds from the static G table and 52 adds from the key's table (a
    negative digit negates the row's y limbs), the corrections 2**256*G
    and 2**260*Q and -S; then Z != 0 and X == r*Z**2 or (r+n)*Z**2.
    Row and key indices are clamped into their tables, as a JAX gather
    clamps them.  Returns (B,) bool.  CUDA tensors: kernel K12."""
    return cuda_secp.msm_verify(qtab, q_corr, gid, g_rows, g_neg, q_rows,
                                q_neg, r_limbs, rn_limbs, rn_valid, s_pt)


# ---------------------------------------------------------------------------
# numpy entry points (the JAX package's device functions)
# ---------------------------------------------------------------------------

def build_q_msm_tables_device(keys_x, keys_y, device="cuda"):
    """One build of the per-key window tables on `device` from
    pack_msm_batch's (22, K) key limbs (cached across commits by
    crypto/secp256k1.QTableCache)."""
    from .. import convert

    dev = devmod.resolve(device)
    return q_msm_tables_kernel(convert.to_device_async(keys_x, np.int32, dev),
                               convert.to_device_async(keys_y, np.int32, dev))


def verify_batch_device(qx, qy, u1_nibs, u2_nibs, r_limbs, rn_limbs,
                        rn_valid, device="cuda"):
    """The ladder on pack_batch's numpy arrays (its `valid` left out),
    launched on `device`; returns the (B,) bool verdict tensor there."""
    from .. import convert

    return verify_kernel(*convert.secp_batch_from_numpy(
        (qx, qy, u1_nibs, u2_nibs, r_limbs, rn_limbs, rn_valid),
        devmod.resolve(device)))


def verify_batch_msm_device(qtab, q_corr, pk: dict, device="cuda"):
    """The MSM program on a pack_msm_batch dict, its key tables already
    on `device`; returns the (B,) bool verdict tensor there."""
    from .. import convert

    return msm_verify_kernel(qtab, q_corr, *convert.secp_msm_from_numpy(
        pk, devmod.resolve(device)))
