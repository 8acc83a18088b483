"""K11 and K12 on the native field (cometbft_tpu_torch/ops/csrc/
fe_secp_n.cuh): the header's constants against Python integers, its
arithmetic compiled for the host against Python integers and the plain
point operations, the plain K11 tables frozen against the JAX package's
tables frozen (the kernel now stores frozen tables), the plain K12's
verdicts on frozen and on weak tables, and a torch model of K12's split
schedule (T threads a signature, blinded partial sums, shuffle combine)
against the plain K12, on the JAX package's packs with hostile lanes."""

import ctypes
import re
import secrets
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import secp256k1 as jsk
from cometbft_tpu.ops import fe_secp as jfs
from cometbft_tpu.ops import secp256k1 as jdev
from cometbft_tpu_torch.crypto import secp256k1 as tsk
from cometbft_tpu_torch.ops import fe_secp as tfs
from cometbft_tpu_torch.ops import secp256k1 as tdev

torch.set_num_threads(1)

P, N = tsk.P, tsk.N
B = 8
CSRC = Path(tfs.__file__).parent / "csrc"


# -- the header ---------------------------------------------------------------

def _constants():
    src = (CSRC / "fe_secp_n.cuh").read_text()
    return {m.group(1): int(m.group(2).rstrip("u"), 0) for m in re.finditer(
        r"\b([A-Z][A-Z0-9_]*) = (0x[0-9A-Fa-f]+u?|\d+u?)\b", src)}


def test_native_header_constants():
    c = _constants()
    assert c["NW"] * 32 == 256 and c["NL"] == tfs.NLIMBS
    assert c["FOLD_LO"] == 977 and c["FOLD_HI"] == 1
    assert (c["FOLD_HI"] << 32) + c["FOLD_LO"] == (1 << 256) % P
    words = [c["P_W0"], c["P_W1"]] + [c["P_WTOP"]] * 6
    assert sum(w << (32 * i) for i, w in enumerate(words)) == P


_HARNESS = r"""
#define __device__
#define __forceinline__ inline
#define __noinline__
#include "fe_secp_n.cuh"
using namespace fesecpn;
static fe ld(const uint32_t* p) { fe r; for (int i = 0; i < 8; ++i) r.w[i] = p[i]; return r; }
static void st(uint32_t* p, const fe& a) { for (int i = 0; i < 8; ++i) p[i] = a.w[i]; }
static jpt ldp(const uint32_t* p) { jpt r; r.x = ld(p); r.y = ld(p + 8); r.z = ld(p + 16); return r; }
static void stp(uint32_t* p, const jpt& a) { st(p, a.x); st(p + 8, a.y); st(p + 16, a.z); }
extern "C" {
void h_mul(const uint32_t* a, const uint32_t* b, uint32_t* o) { st(o, mul(ld(a), ld(b))); }
void h_sqr(const uint32_t* a, uint32_t* o) { st(o, sqr(ld(a))); }
void h_add(const uint32_t* a, const uint32_t* b, uint32_t* o) { st(o, add(ld(a), ld(b))); }
void h_sub(const uint32_t* a, const uint32_t* b, uint32_t* o) { st(o, sub(ld(a), ld(b))); }
void h_neg(const uint32_t* a, uint32_t* o) { st(o, neg(ld(a))); }
void h_freeze(const uint32_t* a, uint32_t* o) { st(o, freeze(ld(a))); }
int h_is_zero(const uint32_t* a) { return is_zero(ld(a)); }
void h_from_limbs(const int32_t* l, uint32_t* o) { st(o, from_limbs(l, 1)); }
void h_to_limbs(const uint32_t* a, int32_t* l) { to_limbs(l, 1, ld(a)); }
void h_jadd(const uint32_t* p, const uint32_t* q, uint32_t* o) { stp(o, jadd_fast(ldp(p), ldp(q))); }
void h_jmix(const uint32_t* p, const uint32_t* q, uint32_t* o) { stp(o, jadd_mixed(ldp(p), ld(q), ld(q + 8))); }
}
"""


def _words(x, n=8):
    return (ctypes.c_uint32 * n)(*[(x >> (32 * i)) & 0xFFFFFFFF
                                   for i in range(n)])


def _value(a):
    return sum(int(a[i]) << (32 * i) for i in range(8))


def _point_words(pt):
    return (ctypes.c_uint32 * 24)(*[(c >> (32 * i)) & 0xFFFFFFFF
                                    for c in pt for i in range(8)])


def _point_value(o):
    return tuple(sum(int(o[8 * c + i]) << (32 * i) for i in range(8)) % P
                 for c in range(3))


def test_native_arithmetic_on_the_host(tmp_path):
    """fe_secp_n.cuh compiled as host C++: every field operation stays in
    [0, 2**256) and equals Python's value mod p, at the edges of p and
    2**256 too; from_limbs reads weak and negative JAX limbs; to_limbs
    writes the canonical digits; the adds give the plain version's
    coordinates at canonical value (the doubling runs on quads, and K11
    holds it against the plain version on the card)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the header for the host")
    src = tmp_path / "harness.cpp"
    src.write_text(_HARNESS)
    so = tmp_path / "libharness.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(CSRC), str(src),
                    "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    rng = np.random.default_rng(14)
    top = 1 << 256
    vals = [0, 1, 2, P - 1, P, P + 1, top - 1, top - 2, top - 977,
            top - (1 << 34), 1 << 255, (1 << 32) + 977, P - (1 << 32),
            (1 << 64) - 1]
    vals += [int.from_bytes(rng.bytes(32), "little") for _ in range(400)]
    vals += [top - int(rng.integers(1 << 40)) for _ in range(50)]
    vals += [int(rng.integers(1 << 40)) for _ in range(50)]
    out = (ctypes.c_uint32 * 8)()
    for k, a in enumerate(vals):
        b = vals[(7 * k + 3) % len(vals)]
        for fn, want in ((lib.h_mul, a * b), (lib.h_add, a + b),
                         (lib.h_sub, a - b)):
            fn(_words(a), _words(b), out)
            assert _value(out) < top and _value(out) % P == want % P, \
                (fn, hex(a), hex(b))
        lib.h_sqr(_words(a), out)
        assert _value(out) < top and _value(out) % P == a * a % P
        lib.h_neg(_words(a), out)
        assert _value(out) % P == -a % P
        lib.h_freeze(_words(a), out)
        assert _value(out) == a % P
        assert lib.h_is_zero(_words(a)) == (a % P == 0)
        digits = (ctypes.c_int32 * 22)()
        lib.h_to_limbs(_words(a), digits)
        assert list(digits) == tfs.int_to_limbs(a).tolist()
    # the folds' edges: a carry (borrow) past word 2, and out of 2**256
    # a second time
    for a, b in ((top - 1, top - 1), (top - 1, 1 << 96), (0, top - 1),
                 ((1 << 96) - 1, top - (1 << 95)), (0, 1 << 96),
                 (5, top - (1 << 64)), (1, top - 978)):
        for x, y in ((a, b), (b, a)):
            for fn, want in ((lib.h_add, x + y), (lib.h_sub, x - y)):
                fn(_words(x), _words(y), out)
                assert _value(out) < top and _value(out) % P == want % P
    for k in range(400):
        limbs = rng.integers(*((-1800, 4901), (-5000, 5001), (0, 4096),
                               (-(1 << 20), 1 << 20))[k % 4], size=22)
        lib.h_from_limbs((ctypes.c_int32 * 22)(*limbs.tolist()), out)
        assert _value(out) < top
        assert _value(out) % P == sum(int(v) << (12 * i)
                                      for i, v in enumerate(limbs)) % P
    pts = []
    for k in range(12):
        x, y = tsk._jaffine(tsk._jmul(int(rng.integers(1, 1 << 62)),
                                      tsk._G))
        z = int.from_bytes(rng.bytes(32), "little") % P if k % 3 else 1
        pts.append((x * z * z % P, y * z ** 3 % P, z))
    qs = pts[1:] + pts[:1]

    def limbs(ps):
        return torch.from_numpy(np.stack([np.stack(
            [tfs.int_to_limbs(c) for c in p]) for p in ps], -1))

    a_t, q_t = limbs(pts), limbs(qs)
    plain = {"jadd": tdev.jadd_fast(a_t, q_t),
             "jmix": tdev.jadd_mixed(a_t, q_t[0], q_t[1])}
    o = (ctypes.c_uint32 * 24)()
    for i, (p_, q_) in enumerate(zip(pts, qs)):
        for name, call in (
                ("jadd", lambda: lib.h_jadd(_point_words(p_),
                                            _point_words(q_), o)),
                ("jmix", lambda: lib.h_jmix(_point_words(p_),
                                            _point_words(q_), o))):
            call()
            want = tuple(tfs.limbs_to_int(plain[name][c, :, i].numpy())
                         for c in range(3))
            assert _point_value(o) == want, (name, i)


# -- fixtures: the JAX package's packs, hostile lanes included -----------------

_PRIVS = [tsk.PrivKey.generate(bytes([90 + i]) * 32) for i in range(4)]


def _signed(n, tag):
    pks, msgs, sigs = [], [], []
    for i in range(n):
        p = _PRIVS[i % len(_PRIVS)]
        m = tag + b" %d" % i
        pks.append(p.pub_key().bytes())
        msgs.append(m)
        sigs.append(p.sign(m))
    return pks, msgs, sigs


def _hostile():
    """B signatures over 4 keys: r = 0, s >= n, the high-s twin of a valid
    signature, a key that fails to decompress, a tampered message and a
    signature under another key on lanes 1-6; lanes 0 and 7 valid."""
    pks, msgs, sigs = _signed(B, b"native")
    sigs[1] = b"\x00" * 32 + sigs[1][32:]
    sigs[2] = sigs[2][:32] + (N + 5).to_bytes(32, "big")
    s3 = int.from_bytes(sigs[3][32:], "big")
    sigs[3] = sigs[3][:32] + (N - s3).to_bytes(32, "big")
    pks[4] = b"\x02" + (P + 1).to_bytes(33, "big")[1:]
    msgs[5] = msgs[5] + b"!"
    pks[6] = pks[7]
    return pks, msgs, sigs


@pytest.fixture(scope="module")
def pack():
    """The JAX package's pack_msm_batch of the hostile lanes and B valid
    ones, the first two of those with the true r moved into the r + n
    slot (rn_valid set on the first alone), the blinding scalar pinned;
    the port's plain K11 tables of its keys, and the verdicts the host
    gives."""
    hostile, valid = _hostile(), _signed(B, b"native rn")
    items = tuple(h + v for h, v in zip(hostile, valid))
    want = [jsk.PubKey(p).verify_signature(m, s) if len(p) == 33 else False
            for p, m, s in zip(*hostile)] + [True, False] + [True] * (B - 2)
    mp = pytest.MonkeyPatch()
    mp.setattr(secrets, "randbelow", lambda n: 0x5EC9 % n)
    try:
        pk = jsk.pack_msm_batch(*items, 2 * B)
    finally:
        mp.undo()
    pk = {k: np.array(v) for k, v in pk.items()}
    for lane, ok in ((B, True), (B + 1, False)):
        r = tfs.limbs_to_int(pk["r_limbs"][:, lane])
        pk["rn_limbs"][:, lane] = tfs.int_to_limbs(r)
        pk["r_limbs"][:, lane] = tfs.int_to_limbs(r + 1)
        pk["rn_valid"][lane] = ok
    qx, qy = (torch.from_numpy(pk[k]) for k in ("keys_x", "keys_y"))
    qtab, qcorr = tdev.q_msm_tables_kernel_plain(qx, qy)
    rest = tuple(torch.from_numpy(np.ascontiguousarray(pk[k]))
                 for k in ("gid", "g_rows", "g_neg", "q_rows", "q_neg",
                           "r_limbs", "rn_limbs", "rn_valid", "s_pt"))
    return {"pk": pk, "tables": (qtab, qcorr), "rest": rest, "want": want}


def _freeze(t):
    """fe_secp.freeze along the limb axis (second to last)."""
    return tfs.freeze(t.movedim(-2, 0)).movedim(0, -2)


# -- K11 ----------------------------------------------------------------------

def _jax_tables(qx, qy):
    """The JAX package's K11 tables, by its jdbl and jadd_fast in its
    scan's order (limb for limb q_msm_tables_kernel's, without the
    scan's whole-program compile), one window at a time."""
    dbl, add = jax.jit(jdev.jdbl), jax.jit(jdev.jadd_fast)
    b = jnp.stack([qx, qy, jnp.broadcast_to(jfs.ONE_LIMBS[:, None],
                                            qx.shape)])
    wins = []
    for _ in range(tdev.MSM_NQ):
        d2 = dbl(b)
        rows = [b]
        for _ in range(15):
            rows.append(add(rows[-1], d2))
        wins.append(jnp.stack(rows))
        for _ in range(tdev.MSM_WQ):
            b = dbl(b)
    return np.asarray(jnp.stack(wins)), np.asarray(b)


def _canonical(limbs):
    """(..., 22, K) limbs of either package -> the canonical digits of
    each coordinate's value mod p, by Python integers."""
    a = np.moveaxis(np.asarray(limbs, np.int64), -2, -1)
    flat = a.reshape(-1, tfs.NLIMBS)
    out = np.stack([tfs.int_to_limbs(tfs.limbs_to_int(v)) for v in flat])
    return np.moveaxis(out.reshape(a.shape), -1, -2)


def test_k11_plain_tables_frozen_equal_jax_frozen(pack):
    """K11 stores its tables frozen: fe_secp.freeze of the plain
    version's weak tables equals the JAX package's tables at canonical
    value, coordinate by coordinate."""
    pk = pack["pk"]
    jt, jc = _jax_tables(pk["keys_x"], pk["keys_y"])
    qtab, qcorr = pack["tables"]
    tt_f, tc_f = _freeze(qtab), _freeze(qcorr)
    assert (tt_f.numpy() == _canonical(jt)).all()
    assert (tc_f.numpy() == _canonical(jc)).all()
    assert not (qtab == tt_f).all()      # the plain tables are weak


# -- K12 ----------------------------------------------------------------------

def test_k12_plain_verdicts_on_frozen_and_weak_tables(pack):
    """On the card K12 and its plain version read K11's frozen tables:
    the plain K12 gives the same verdicts on them as on the weak ones,
    every hostile class and the r + n slot included, and the host's."""
    qtab, qcorr = pack["tables"]
    weak = tdev.msm_verify_kernel_plain(qtab, qcorr, *pack["rest"])
    frozen = tdev.msm_verify_kernel_plain(_freeze(qtab), _freeze(qcorr),
                                          *pack["rest"])
    assert (weak == frozen).all()
    assert (frozen.numpy() & pack["pk"]["valid"]).tolist() == pack["want"]


def _k12_split_model(qtab, q_corr, gid, g_rows, g_neg, q_rows, q_neg,
                     r_limbs, rn_limbs, rn_valid, s_pt, t_split):
    """K12's schedule in torch: thread t of a signature starts at m_t S,
    m = (1, 2, 4, 1) by t mod 4, adds the G windows t, t + T, ... (mixed
    adds), then the Q slots t, t + T, ...: the 52 key-table rows, 2**260 Q,
    2**256 G as a Jacobian point and -2T S; the partials fold by
    shuffle-down rounds onto thread 0, which runs the epilogue."""
    T, b = t_split, gid.shape[0]
    gtab, gcorr, _ = tdev.g_tables_on(gid.device)
    nk = qtab.shape[-1]
    slot = gid.long().clamp(0, nk - 1)
    s1 = s_pt[:, :, None]
    s2 = tdev.jdbl(s1)
    s4 = tdev.jdbl(s2)
    sm = tdev.jdbl(s4)
    for _ in range(T // 8):
        sm = tdev.jdbl(sm)
    minus = tdev._pt(sm[0], -sm[1], sm[2])
    start = [s1, s2, s4, s1]
    acc = torch.stack([start[t % 4][..., 0] for t in range(T)], -1)
    acc = acc[..., None].expand(3, tfs.NLIMBS, T, b).reshape(
        3, tfs.NLIMBS, T * b)
    lanes = torch.arange(b)
    for it in range(tdev.MSM_NG // T):
        win = it * T + torch.arange(T)
        rows = g_rows.long()[win].clamp(0, 127)                  # (T, B)
        ent = gtab[win[:, None], rows]                           # (T, B, 2, 22)
        ay = torch.where(g_neg[win][..., None], -ent[..., 1, :],
                         ent[..., 1, :])
        acc = tdev.jadd_mixed(acc, ent[..., 0, :].permute(2, 0, 1).reshape(
            tfs.NLIMBS, -1), ay.permute(2, 0, 1).reshape(tfs.NLIMBS, -1))
    one = torch.from_numpy(tfs.ONE_LIMBS)[:, None].expand(tfs.NLIMBS, b)
    extra = [q_corr[:, :, slot],
             tdev._pt(gcorr[0][:, None].expand(tfs.NLIMBS, b),
                      gcorr[1][:, None].expand(tfs.NLIMBS, b), one),
             minus.expand(3, tfs.NLIMBS, b)]
    nslots = tdev.MSM_NQ + len(extra)
    for it in range(-(-nslots // T)):
        ents, skip = [], []
        for t in range(T):
            s = it * T + t
            if s < tdev.MSM_NQ:
                row = q_rows[s].long().clamp(0, 15)
                e = qtab[s][row, :, :, slot].permute(1, 2, 0)
                e = tdev._pt(e[0], torch.where(q_neg[s][None], -e[1], e[1]),
                             e[2])
            else:
                e = extra[min(s - tdev.MSM_NQ, len(extra) - 1)]
            ents.append(e)
            skip.append(torch.full((b,), s >= nslots))
        ent = torch.stack(ents, 2).reshape(3, tfs.NLIMBS, T * b)
        added = tdev.jadd_fast(acc, ent)
        acc = torch.where(torch.cat(skip)[None, None], acc, added)
    acc = acc.reshape(3, tfs.NLIMBS, T, b)
    off = 1
    while off < T:
        acc = acc.clone()
        acc[:, :, 0::2 * off] = tdev.jadd_fast(acc[:, :, 0::2 * off],
                                               acc[:, :, off::2 * off])
        off *= 2
    acc = acc[:, :, 0, lanes]
    z2 = tfs.sqr(acc[2])
    not_inf = ~tfs.is_zero(acc[2])
    ok_r = tfs.eq(acc[0], tfs.mul(r_limbs, z2))
    ok_rn = tfs.eq(acc[0], tfs.mul(rn_limbs, z2)) & rn_valid
    return not_inf & (ok_r | ok_rn)


@pytest.mark.parametrize("t_split", [4, 8])
def test_k12_split_schedule_model_equals_plain(pack, t_split):
    """The split sum (partials blinded by multiples of S, the corrections
    and -2T S as Q slots, the shuffle combine) gives the plain K12's
    verdicts on K11's frozen tables, lane for lane."""
    qtab, qcorr = (_freeze(t) for t in pack["tables"])
    args = (qtab, qcorr) + pack["rest"]
    got = _k12_split_model(*args, t_split)
    assert (got == tdev.msm_verify_kernel_plain(*args)).all()
    assert (got.numpy() & pack["pk"]["valid"]).tolist() == pack["want"]
