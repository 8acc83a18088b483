"""The port's secp256k1 path (ops/secp256k1.py, ops/msm.py, ops/cuda_secp.py,
crypto/secp256k1.py, its part of crypto/batch.py) against the JAX package:
point operations limb for limb, the odd recode, the packers byte for
byte (the blinding scalar pinned in both), the K11 tables against the
group law of the JAX package's host arithmetic, the K12 and K13 plain
versions' verdicts against its host verify on every hostile class, the
routing, the key-table cache and the variables the port reads.

The JAX package's whole device programs take tens of seconds each to
compile on the CPU, so the tests that run them are in the slow tier (the
last section)."""

import importlib
import secrets

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import secp256k1 as jsk
from cometbft_tpu.ops import msm as jmsm
from cometbft_tpu.ops import secp256k1 as jdev
from cometbft_tpu.types import validator_set as jvs
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import secp256k1 as tsk
from cometbft_tpu_torch.crypto import sigcache as tsigcache
from cometbft_tpu_torch.ops import cuda_secp
from cometbft_tpu_torch.ops import fe_secp as tfs
from cometbft_tpu_torch.ops import msm as tmsm
from cometbft_tpu_torch.ops import secp256k1 as tdev
from cometbft_tpu_torch.types import validator_set as tvs

torch.set_num_threads(1)

P, N = tsk.P, tsk.N
B = 8


# -- fixtures -----------------------------------------------------------------


@pytest.fixture(autouse=True)
def _port_sigcache():
    """The port's signature-verdict cache is process-wide: a triple
    verified in one test (or another file on the same worker) would be a
    hit in the next and skip the program that test means to run.  Start
    and end every test with an empty cache in the default state."""
    tsigcache.reset()
    tsigcache.set_enabled(None)
    yield
    tsigcache.reset()
    tsigcache.set_enabled(None)

_PRIVS = [tsk.PrivKey.generate(bytes([70 + i]) * 32) for i in range(4)]


def _signed(n, tag=b"secp port"):
    pks, msgs, sigs = [], [], []
    for i in range(n):
        p = _PRIVS[i % len(_PRIVS)]
        m = tag + b" %d" % i
        pks.append(p.pub_key().bytes())
        msgs.append(m)
        sigs.append(p.sign(m))
    return pks, msgs, sigs


def _hostile():
    """B signatures over 4 keys, six of them broken, one class each:
    r = 0, s >= n, the high-s twin of a valid signature, a key that
    fails to decompress, a tampered message, a signature under another
    key; lanes 0 and 7 stay valid."""
    pks, msgs, sigs = _signed(B)
    s1 = int.from_bytes(sigs[1][32:], "big")
    sigs[1] = b"\x00" * 32 + sigs[1][32:]
    sigs[2] = sigs[2][:32] + (N + 5).to_bytes(32, "big")
    s3 = int.from_bytes(sigs[3][32:], "big")
    sigs[3] = sigs[3][:32] + (N - s3).to_bytes(32, "big")
    pks[4] = b"\x02" + (P + 1).to_bytes(33, "big")[1:]
    msgs[5] = msgs[5] + b"!"
    pks[6] = pks[7]
    assert s1
    return pks, msgs, sigs


def _oracle(pks, msgs, sigs):
    """The JAX package's host verdicts, equal to the port's _verify_py."""
    want = [jsk.PubKey(p).verify_signature(m, s) if len(p) == 33 else False
            for p, m, s in zip(pks, msgs, sigs)]
    assert want == [tsk.PubKey(p).verify_signature(m, s)
                    for p, m, s in zip(pks, msgs, sigs)]
    return want


@pytest.fixture
def pinned_t(monkeypatch):
    """secrets.randbelow pinned, so both packages draw the same blinding
    scalar."""
    monkeypatch.setattr(secrets, "randbelow", lambda n: 0x1234567 % n)


def _jac(pt, z):
    """Affine (x, y) as Jacobian (x z^2, y z^3, z) limbs, (3, 22)."""
    x, y = pt
    return np.stack([tfs.int_to_limbs(x * z * z % P),
                     tfs.int_to_limbs(y * z * z * z % P),
                     tfs.int_to_limbs(z)])


def _affine(limbs):
    """(3, 22) Jacobian limbs -> affine ints (None at Z = 0)."""
    x, y, z = (tfs.limbs_to_int(limbs[c]) for c in range(3))
    return None if z == 0 else tsk._jaffine((x, y, z))


def _kg(k):
    return jsk._jaffine(jsk._jmul(k, jsk._G))


# -- point operations -----------------------------------------------------------

def _points():
    """(3, 22, 8) Jacobian points with random Z, and their affine ints."""
    affs = [_kg(k) for k in (3, 5, 7, 11, 13, 17, 19, 23)]
    limbs = np.stack([_jac(a, 1000 + 37 * i) for i, a in enumerate(affs)],
                     axis=-1)
    return limbs, affs


def test_jdbl_jadd_mixed_and_jadd_fast():
    """jdbl and jadd_mixed limb for limb against the JAX package, and
    each lane's sum against its host arithmetic (lane i adds point i-1)."""
    p, affs = _points()
    q = np.roll(p, 1, axis=-1)
    prev = affs[-1:] + affs[:-1]
    ax, ay = (np.stack([tfs.int_to_limbs(a[c]) for a in prev], -1)
              for c in range(2))
    got = tdev.jdbl(torch.from_numpy(p)).numpy()
    assert (got == np.asarray(jdev.jdbl(jnp.asarray(p)))).all()
    for i, a in enumerate(affs):
        assert _affine(got[..., i]) == jsk._jaffine(jsk._jdbl(a + (1,)))
    got_m = tdev.jadd_mixed(torch.from_numpy(p), torch.from_numpy(ax),
                            torch.from_numpy(ay)).numpy()
    want = jdev.jadd_mixed(jnp.asarray(p), jnp.asarray(ax), jnp.asarray(ay))
    assert (got_m == np.asarray(want)).all()
    got_f = tdev.jadd_fast(torch.from_numpy(p), torch.from_numpy(q)).numpy()
    for i in range(8):
        want_pt = jsk._jaffine(jsk._jadd(affs[i] + (1,), prev[i] + (1,)))
        assert _affine(got_f[..., i]) == want_pt
        assert _affine(got_m[..., i]) == want_pt


def test_jadd_complete_branches_match_jax():
    """Lane by lane: generic, P + P under another Z (doubling), P + (-P)
    (infinity, the (1, 1, 1) filler), infinity + Q, P + infinity, both
    at infinity, and two generic lanes."""
    a, b = _kg(9), _kg(12)
    neg_a = (a[0], P - a[1])
    rows_p = [_jac(a, 5), _jac(a, 7), _jac(a, 3), _jac(a, 2),
              _jac(b, 4), _jac(b, 9), _jac(b, 6), _jac(a, 8)]
    rows_q = [_jac(b, 3), _jac(a, 11), _jac(neg_a, 5), _jac(b, 1),
              _jac(a, 2), _jac(a, 3), _jac(a, 7), _jac(b, 2)]
    p = np.stack(rows_p, -1)
    q = np.stack(rows_q, -1)
    p_inf = np.array([0, 0, 0, 1, 0, 1, 0, 0], bool)
    q_inf = np.array([0, 0, 0, 0, 1, 1, 0, 0], bool)
    got, got_inf = tdev.jadd_complete(
        torch.from_numpy(p), torch.from_numpy(p_inf), torch.from_numpy(q),
        torch.from_numpy(q_inf))
    want, want_inf = jdev.jadd_complete(jnp.asarray(p), jnp.asarray(p_inf),
                                        jnp.asarray(q), jnp.asarray(q_inf))
    assert (got.numpy() == np.asarray(want)).all()
    assert got_inf.tolist() == np.asarray(want_inf).tolist() == \
        [False, False, True, False, False, True, False, False]
    expect = [jsk._jaffine(jsk._jadd(a + (1,), b + (1,))),
              jsk._jaffine(jsk._jdbl(a + (1,))), None, b, b, None,
              jsk._jaffine(jsk._jadd(b + (1,), a + (1,))),
              jsk._jaffine(jsk._jadd(a + (1,), b + (1,)))]
    for i in (0, 1, 3, 4, 6, 7):
        assert _affine(got.numpy()[..., i]) == expect[i], i
    assert (got.numpy()[..., 2] == np.stack([tfs.ONE_LIMBS] * 3)).all()


def test_select_and_q_table():
    _, affs = _points()
    qx, qy = (np.stack([tfs.int_to_limbs(a[c]) for a in affs], -1)
              for c in range(2))
    tab = tdev._q_table(torch.from_numpy(qx), torch.from_numpy(qy)).numpy()
    for i, a in enumerate(affs):
        assert (tab[0, :, :, i] == np.stack([tfs.ONE_LIMBS] * 3)).all()
        for k in range(1, 16):
            assert _affine(tab[k, :, :, i]) == \
                jsk._jaffine(jsk._jmul(k, a + (1,))), (i, k)
    nib = np.array([0, 1, 15, 16, -1, 7, 3, 9], np.int32)
    got = tdev._select(torch.from_numpy(tab), torch.from_numpy(nib))
    want = jdev._select(jnp.asarray(tab), jnp.asarray(nib))
    assert (got.numpy() == np.asarray(want)).all()


def test_g_tables_match_jax():
    assert (tdev.g_table() == jdev._g_table_np()).all()
    rows, corr = tdev.g_msm_table()
    jrows, jcorr = jdev._g_msm_table()
    assert (rows == jrows).all() and (corr == jcorr).all()
    for name in ("N_ORDER", "GX", "GY", "MSM_WG", "MSM_NG", "MSM_WQ",
                 "MSM_NQ"):
        assert getattr(tdev, name) == getattr(jdev, name)


# -- recode and packers ------------------------------------------------------------

@pytest.mark.parametrize("width, ndig", [(8, 32), (5, 52)])
def test_recode_jt_matches_jax_and_closed_form(width, ndig):
    rng = np.random.default_rng(width)
    ks = [int.from_bytes(rng.bytes(33), "big") % (2 * N) | 1
          for _ in range(64)] + [1, 2 * N - 1, N, N + 2]
    rows, negs = tmsm.recode_jt(ks, width, ndig)
    jrows, jnegs = jmsm.recode_jt(ks, width, ndig)
    assert (rows == jrows).all() and (negs == jnegs).all()
    assert rows.dtype == jrows.dtype and negs.dtype == jnegs.dtype
    assert rows.min() >= 0 and rows.max() < 1 << (width - 1)
    for i, k in enumerate(ks):
        v = tmsm.jt_digit_value(rows[:, i], negs[:, i], width)
        assert v == jmsm.jt_digit_value(rows[:, i], negs[:, i], width)
        assert v + (1 << (width * ndig)) == k


def test_pack_batch_matches_jax():
    pks, msgs, sigs = _hostile()
    got = tsk.pack_batch(pks, msgs, sigs, 16)
    want = jsk.pack_batch(pks, msgs, sigs, 16)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and (g == w).all()
    assert got[-1].tolist()[:B] == [True, False, False, False, False, True,
                                    True, True]


def test_pack_msm_batch_matches_jax(pinned_t):
    pks, msgs, sigs = _hostile()
    got = tsk.pack_msm_batch(pks, msgs, sigs, 16)
    want = jsk.pack_msm_batch(pks, msgs, sigs, 16)
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], bytes):
            assert got[k] == want[k], k
        else:
            assert got[k].dtype == want[k].dtype and \
                (got[k] == want[k]).all(), k
    assert got["keys_x"].shape == (tfs.NLIMBS, 4)


def test_key_pad_and_parse_match_jax():
    assert tsk._KEY_WIDTHS == jsk._KEY_WIDTHS
    for k in (1, 4, 5, 96, 97, 192, 256, 257, 600):
        assert tsk._key_pad(k) == jsk._key_pad(k)
    pks, _, sigs = _hostile()
    for s in sigs + [b"", b"\x01" * 63]:
        assert tsk.parse_signature(s) == jsk.parse_signature(s)
    for p in pks + [b"\x04" + b"\x01" * 32, b"\x02" * 2]:
        assert tsk._decompress(p) == jsk._decompress(p)


def test_keys_sign_and_address_match_jax():
    for seed in (b"a", b"validator-3"):
        t, j = tsk.PrivKey.generate(seed), jsk.PrivKey.generate(seed)
        assert t.bytes() == j.bytes()
        assert t.pub_key().bytes() == j.pub_key().bytes()
        assert t.pub_key().address() == j.pub_key().address()
        assert t.sign(b"msg") == j.sign(b"msg")
    for m in (b"", b"abc", b"a" * 55, b"a" * 64, bytes(range(200))):
        assert tsk._ripemd160_py(m) == tsk.ripemd160(m)


# -- K11 -------------------------------------------------------------------------------

def test_k11_tables_follow_the_group_law():
    """Every row m of window j is (2m+1) 2^(5j) Q and the correction is
    2^260 Q, by the JAX package's host arithmetic; the four keys are
    two real ones and two G fillers, as pack_msm_batch pads them."""
    pks, msgs, sigs = _signed(2)
    pk = tsk.pack_msm_batch(pks, msgs, sigs, 16)
    qtab, corr = tdev.build_q_msm_tables_device(pk["keys_x"], pk["keys_y"],
                                                device="cpu")
    qtab, corr = qtab.numpy(), corr.numpy()
    assert qtab.shape == (52, 16, 3, 22, 4) and corr.shape == (3, 22, 4)
    for k in range(4):
        q = (tfs.limbs_to_int(pk["keys_x"][:, k]),
             tfs.limbs_to_int(pk["keys_y"][:, k]), 1)
        base = q
        for j in range(52):
            d2 = jsk._jdbl(base)
            cur = base
            for m in range(16):
                assert _affine(qtab[j, m, :, :, k]) == jsk._jaffine(cur), \
                    (k, j, m)
                cur = jsk._jadd(cur, d2)
            for _ in range(5):
                base = jsk._jdbl(base)
        assert _affine(corr[..., k]) == jsk._jaffine(base)


def test_k11_two_steps_equal_the_window_scan():
    """The kernel's split (bases, then rows per window) computes the JAX
    scan's values: window j's rows from 2^(5j) Q, limb for limb."""
    pks, msgs, sigs = _signed(1)
    pk = tsk.pack_msm_batch(pks, msgs, sigs, 16)
    qx, qy = torch.from_numpy(pk["keys_x"]), torch.from_numpy(pk["keys_y"])
    bases, _ = tdev.q_window_bases_plain(qx, qy)
    b = tdev._pt(qx, qy, tdev._one_fe(qx.shape[1:], "cpu"))
    for _ in range(5 * 3):
        b = tdev.jdbl(b)
    assert (bases[3] == b).all()
    rows = tdev.q_window_rows_plain(bases[3:4])[0]
    d2 = tdev.jdbl(b)
    cur = b
    for m in range(16):
        assert (rows[m] == cur).all()
        cur = tdev.jadd_fast(cur, d2)


# -- K12 and K13 verdicts --------------------------------------------------------

def _move_r_to_rn(r_limbs, rn_limbs, rn_valid):
    """Lanes B and B+1 carry a wrong r and the true r in the r + n slot,
    lane B with rn_valid set, lane B+1 without: X == (r+n) Z^2 must
    accept lane B alone."""
    r_limbs, rn_limbs, rn_valid = (x.copy() for x in (r_limbs, rn_limbs,
                                                      rn_valid))
    for lane, valid in ((B, True), (B + 1, False)):
        r = tfs.limbs_to_int(r_limbs[:, lane])
        rn_limbs[:, lane] = tfs.int_to_limbs(r)
        r_limbs[:, lane] = tfs.int_to_limbs(r + 1)
        rn_valid[lane] = valid
    return r_limbs, rn_limbs, rn_valid


def _cases():
    """The hostile lanes, then B valid ones of which the first two get
    the r + n treatment."""
    hostile = _hostile()
    valid = _signed(B, tag=b"rn")
    items = tuple(h + v for h, v in zip(hostile, valid))
    want = _oracle(*hostile) + [True, False] + [True] * (B - 2)
    return items, want


def test_k13_plain_verdicts_on_jax_packs():
    """The JAX package's pack_batch through convert into the port's
    ladder: every hostile class and the r + n slot."""
    items, want = _cases()
    packed = list(jsk.pack_batch(*items, 2 * B))
    packed[4:7] = _move_r_to_rn(*packed[4:7])
    args = convert.secp_batch_from_numpy(packed[:-1], "cpu")
    assert [a.dtype for a in args] == [torch.int32] * 6 + [torch.bool]
    v = tdev.verify_kernel(*args).numpy()
    assert (v & packed[-1]).tolist() == want
    assert _oracle(*_hostile()) == [True] + [False] * 6 + [True]


def test_k12_plain_verdicts(pinned_t):
    items, want = _cases()
    pk = tsk.pack_msm_batch(*items, 2 * B)
    pk["r_limbs"], pk["rn_limbs"], pk["rn_valid"] = _move_r_to_rn(
        pk["r_limbs"], pk["rn_limbs"], pk["rn_valid"])
    qtab, corr = tdev.build_q_msm_tables_device(pk["keys_x"], pk["keys_y"],
                                                device="cpu")
    v = tdev.verify_batch_msm_device(qtab, corr, pk, device="cpu").numpy()
    assert (v & pk["valid"]).tolist() == want


def test_wrappers_route_cpu_tensors_to_the_plain_versions(monkeypatch):
    counts = (cuda_secp.q_msm_tables.launches, cuda_secp.msm_verify.launches,
              cuda_secp.verify_ladder.launches)
    pks, msgs, sigs = _signed(2)
    tsk.verify_msm_batch(pks, msgs, sigs, device="cpu")
    assert counts == (cuda_secp.q_msm_tables.launches,
                      cuda_secp.msm_verify.launches,
                      cuda_secp.verify_ladder.launches)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tsk.verify_msm_batch(pks, msgs, sigs),
                 lambda: tdev.build_q_msm_tables_device(
                     np.zeros((22, 4), np.int32), np.zeros((22, 4),
                                                           np.int32)),
                 lambda: tbatch.create_batch_verifier("secp256k1")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# -- routing, cache, variables ----------------------------------------------------------

def test_secp_verifiers_route_as_jax(monkeypatch):
    from cometbft_tpu.crypto import batch as jb

    monkeypatch.delenv("COMETBFT_TPU_PROVIDER", raising=False)
    for n, cls, jcls in ((64, "CpuSecp256k1BatchVerifier",
                          "CpuSecp256k1BatchVerifier"),
                         (256, "CudaSecp256k1BatchVerifier",
                          "TpuSecp256k1BatchVerifier")):
        assert type(tbatch.create_batch_verifier(
            "secp256k1", n_hint=n, device="cpu")).__name__ == cls
        assert type(jb.create_batch_verifier(
            "secp256k1", n_hint=n)).__name__ == jcls
    assert tbatch._device_threshold("secp256k1") == \
        jb._device_threshold("secp256k1") == 96
    assert tbatch._device_threshold("ed25519") == \
        jb._device_threshold("ed25519")
    assert isinstance(tbatch.create_batch_verifier(
        "secp256k1", 1, device="cpu", provider="tpu"),
        tbatch.CudaSecp256k1BatchVerifier)
    assert isinstance(tbatch.create_batch_verifier(
        "secp256k1", 10_000, device="cpu", provider="cpu"),
        tbatch.CpuSecp256k1BatchVerifier)
    for kt in ("bls12_381", "sr25519x"):
        with pytest.raises(ValueError):
            tbatch.create_batch_verifier(kt, device="cpu")


def test_cuda_verifier_takes_the_program_the_switch_names(monkeypatch):
    """COMETBFT_TPU_SECP_MSM, read on each call: unset or 1 runs the MSM
    program (K11 on a table miss, then K12), 0 the ladder (K13).  The
    programs are stand-ins that accept every lane (their verdicts are
    held elsewhere): this is the route alone."""
    calls = []

    def program(name):
        def run(*args, device="cpu"):
            calls.append(name)
            return torch.ones(16, dtype=torch.bool)
        return run

    monkeypatch.setattr(tdev, "verify_batch_msm_device", program("msm"))
    monkeypatch.setattr(tdev, "verify_batch_device", program("ladder"))
    monkeypatch.setattr(tdev, "build_q_msm_tables_device",
                        lambda x, y, device: (torch.zeros(1), None))
    pks, msgs, sigs = _signed(3)
    for env, program in (("1", "msm"), ("0", "ladder"), (None, "msm")):
        if env is None:
            monkeypatch.delenv("COMETBFT_TPU_SECP_MSM", raising=False)
        else:
            monkeypatch.setenv("COMETBFT_TPU_SECP_MSM", env)
        assert tsk.msm_enabled() == (program == "msm")
        bv = tbatch.create_batch_verifier("secp256k1", device="cpu",
                                          provider="tpu")
        for item in zip(pks, msgs, sigs):
            bv.add(*item)
        calls.clear()
        assert bv.verify() == (True, [True] * 3)
        assert calls == [program]


def test_threshold_and_cache_budget_read_from_the_environment(monkeypatch):
    from cometbft_tpu.crypto import batch as jb

    monkeypatch.setenv("COMETBFT_TPU_SECP_THRESHOLD", "300")
    monkeypatch.setenv("COMETBFT_TPU_Q_CACHE_BYTES", str(5 << 20))
    try:
        importlib.reload(tbatch)
        assert tbatch.SECP_DEVICE_THRESHOLD == 300
        assert tbatch._device_threshold("secp256k1") == 300
        assert isinstance(tbatch.create_batch_verifier(
            "secp256k1", 299, device="cpu"),
            tbatch.CpuSecp256k1BatchVerifier)
        assert isinstance(tbatch.create_batch_verifier(
            "secp256k1", 300, device="cpu"),
            tbatch.CudaSecp256k1BatchVerifier)
        assert tsk.QTableCache()._max_bytes == \
            jsk.QTableCache()._max_bytes == 5 << 20
        monkeypatch.setattr(jb, "DEVICE_THRESHOLD", 400)
        monkeypatch.setattr(tbatch, "DEVICE_THRESHOLD", 400)
        assert tbatch._device_threshold("secp256k1") == \
            jb._device_threshold("secp256k1") == 400
    finally:
        monkeypatch.undo()
        importlib.reload(tbatch)
    assert tsk.QTableCache()._max_bytes == 128 << 20


def test_q_table_cache_hits_and_lru_eviction_by_bytes(monkeypatch):
    """The cache's policy, with a stand-in for the K11 build (its
    tables are held above)."""
    built = []

    def build(keys_x, keys_y, device):
        built.append(device)
        nk = keys_x.shape[-1]
        return (torch.zeros((52, 16, 3, 22, nk), dtype=torch.int32),
                torch.zeros((3, 22, nk), dtype=torch.int32))

    monkeypatch.setattr(tdev, "build_q_msm_tables_device", build)
    sets = [_signed(1, tag=b"set %d" % i) for i in range(2)]
    sets[1] = ([tsk.PrivKey.generate(b"other").pub_key().bytes()],
               sets[1][1], [tsk.PrivKey.generate(b"other").sign(
                   sets[1][1][0])])
    packs = [tsk.pack_msm_batch(*s, 16) for s in sets]
    one = 52 * 16 * 3 * 22 * 4 * 4
    cache = tsk.QTableCache(max_bytes=one + one // 2)
    a0 = cache.get(packs[0]["key_id"], packs[0]["keys_x"],
                   packs[0]["keys_y"], device="cpu")
    assert (cache.hits, cache.misses, cache.bytes_resident) == (0, 1, one)
    assert cache.get(packs[0]["key_id"], packs[0]["keys_x"],
                     packs[0]["keys_y"], device="cpu") is a0
    assert cache.hits == 1
    cache.get(packs[1]["key_id"], packs[1]["keys_x"], packs[1]["keys_y"],
              device="cpu")
    assert (cache.misses, cache.evictions, cache.bytes_resident) == \
        (2, 1, one)
    small = tsk.QTableCache(max_bytes=one // 2)
    small.get(packs[0]["key_id"], packs[0]["keys_x"], packs[0]["keys_y"],
              device="cpu")
    assert (small.misses, small.bytes_resident) == (1, 0)
    assert len(built) == 3


def test_validator_set_hash_of_secp_keys_matches_jax():
    keys = [tsk.PrivKey.generate(b"v%d" % i).pub_key().bytes()
            for i in range(5)]
    tv = tvs.ValidatorSet([tvs.Validator(tsk.PubKey(k), 10 + i)
                           for i, k in enumerate(keys)])
    jv = jvs.ValidatorSet([jvs.Validator(jsk.PubKey(k), 10 + i)
                           for i, k in enumerate(keys)])
    assert [v.address for v in tv.validators] == \
        [v.address for v in jv.validators]
    assert [v.bytes() for v in tv.validators] == \
        [v.bytes() for v in jv.validators]
    assert tv.hash(device="cpu") == jv.hash()


# -- the JAX package's whole programs (slow: tens of seconds of compile each) ---

@pytest.mark.slow
def test_k11_tables_equal_jax_limb_for_limb():
    pks, msgs, sigs = _hostile()
    pk = tsk.pack_msm_batch(pks, msgs, sigs, 16)
    jt, jc = jdev.build_q_msm_tables_device(pk["keys_x"], pk["keys_y"])
    tt, tc = tdev.build_q_msm_tables_device(pk["keys_x"], pk["keys_y"],
                                            device="cpu")
    assert (tt.numpy() == np.asarray(jt)).all()
    assert (tc.numpy() == np.asarray(jc)).all()
    tq, tqc = convert.q_tables_from_numpy(np.asarray(jt), np.asarray(jc),
                                          "cpu")
    assert (tq == tt).all() and (tqc == tc).all()


@pytest.mark.slow
def test_k12_plain_equals_jax_msm_verify(pinned_t):
    pks, msgs, sigs = _hostile()
    pks2, msgs2, sigs2 = _signed(8, tag=b"more")
    pk = tsk.pack_msm_batch(pks + pks2, msgs + msgs2, sigs + sigs2, 16)
    jt, jc = jdev.build_q_msm_tables_device(pk["keys_x"], pk["keys_y"])
    want = np.asarray(jdev.verify_batch_msm_device(
        jt, jc, pk["gid"], pk["g_rows"], pk["g_neg"], pk["q_rows"],
        pk["q_neg"], pk["r_limbs"], pk["rn_limbs"], pk["rn_valid"],
        pk["s_pt"]))
    tt, tc = convert.q_tables_from_numpy(np.asarray(jt), np.asarray(jc),
                                         "cpu")
    got = tdev.verify_batch_msm_device(tt, tc, pk, device="cpu").numpy()
    assert (got == want).all()
    assert (got & pk["valid"]).tolist() == _oracle(
        pks + pks2, msgs + msgs2, sigs + sigs2)


@pytest.mark.slow
def test_k13_plain_equals_jax_ladder():
    pks, msgs, sigs = _hostile()
    pks2, msgs2, sigs2 = _signed(8, tag=b"more")
    packed = tsk.pack_batch(pks + pks2, msgs + msgs2, sigs + sigs2, 16)
    want = np.asarray(jdev.verify_batch_device(*packed[:-1]))
    got = tdev.verify_batch_device(*packed[:-1], device="cpu").numpy()
    assert (got == want).all()
