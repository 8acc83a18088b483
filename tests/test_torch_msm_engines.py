"""The port's MSM engine configurations against the JAX package, on the
CPU: the routing of cometbft_tpu_torch/ops/ed25519.py (_msm_scan,
_loop_partials, the two RLC programs) and the plain versions of K5
(grouped window-major), K6 (window-loop) and K7 (select-tree) in
ops/cuda_msm.py, which the CPU wrappers run.

K6's and K7's partials are held against the Pallas kernels in interpret
mode output lane by output lane, at canonical values (frozen, affine);
K5's equal its 32-lane per-block order limb for limb and sum, as K3's
partials do, to the JAX XLA scan; the RLC
verdicts under every configuration equal the JAX rlc_verify_kernel's on
the same packed inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import ed25519 as jdev
from cometbft_tpu.ops import msm as jmsm
from cometbft_tpu.ops import pallas_msm as pm
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import ed25519_ref as tref
from cometbft_tpu_torch.ops import cuda_msm
from cometbft_tpu_torch.ops import ed25519 as tdev
from cometbft_tpu_torch.ops import fe as tfe

P = tfe.P

# K6 / K7 against the interpret-mode kernels: two 8-lane blocks, each
# halved to 4 output lanes (OUT_PER_BLK lowered from 128 on both sides),
# and two windows (the first sets the accumulators, the second doubles
# and adds), so the grid slicing, the halving order and the block-major
# partial layout are all exercised at one interpret compile.
LOOP_W, LOOP_NWIN, LOOP_BLK, LOOP_OUT = 16, 2, 8, 4
# K5: a ragged second 32-lane block, 6 windows (groups 2, 3 and 6 divide)
GROUP_W, GROUP_NWIN = 40, 6


def _affine_points(n, salt=0, distinct=8):
    """n points (x, y) as Python ints: multiples of B, tiled."""
    out = []
    for i in range(distinct):
        x, y, z, _ = tref.point_mul(7919 * (i + 1) + 3 + salt, tref.B)
        zi = pow(z, P - 2, P)
        out.append((x * zi % P, y * zi % P))
    return [out[i % distinct] for i in range(n)]


def _limbs(pts):
    """[(x, y)] -> (4, 20, n) int32 extended points, Z = 1."""
    cols = [(x, y, 1, x * y % P) for x, y in pts]
    return np.stack([np.stack([tfe.int_to_limbs(c[k]) for c in cols], 1)
                     for k in range(4)]).astype(np.int32)


def _proj(pt):
    """(4, 20, n) limbs -> per lane (x, y) affine Python ints."""
    pt = np.asarray(pt)
    out = []
    for i in range(pt.shape[-1]):
        x, y, z = (tfe.limbs_to_int(pt[c, :, i]) for c in range(3))
        zi = pow(z, P - 2, P)
        out.append((x * zi % P, y * zi % P))
    return out


def _msm_inputs(w, nwin, seed):
    """Negated tables (port plain K2, limb-equal to the JAX package's)
    and signed digits, with out-of-range magnitudes 17, 31 and -1 in
    window 1 (they select the identity)."""
    rng = np.random.default_rng(seed)
    tab = cuda_msm.table17_neg(torch.from_numpy(
        _limbs(_affine_points(w, salt=seed))))
    mags = rng.integers(0, 17, (nwin, w)).astype(np.int32)
    negs = rng.integers(0, 2, (nwin, w)) != 0
    mags[1, :3] = (17, 31, -1)
    return tab, mags, negs


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions run thousands of small torch ops; beside other
    busy test workers, OpenMP's threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _default_engine(monkeypatch):
    """The JAX package's defaults, whatever the environment says."""
    monkeypatch.delenv("COMETBFT_TPU_MSM_ENGINE", raising=False)
    for name, value in (("USE_PALLAS_MSM_MAJOR", True),
                        ("USE_PALLAS_MSM_LOOP", True),
                        ("USE_PALLAS_TREE", False),
                        ("USE_PALLAS_FOLD", True)):
        monkeypatch.setattr(tdev, name, value)
    monkeypatch.setattr(cuda_msm, "WIN_GROUP", 1)
    monkeypatch.setattr(cuda_msm, "BLK", 512)
    monkeypatch.setattr(cuda_msm, "OUT_PER_BLK", 128)


# -- block and group helpers -------------------------------------------------

@pytest.mark.parametrize("blk, w", [
    (384, 4096), (384, 128), (384, 768), (512, 4096), (96, 64), (96, 192),
    (-5, 4096), (512, 128), (512, 5120), (512, 10240), (512, 8192),
    (512, 16), (512, 160), (512, 192), (512, 320), (1024, 4096), (8, 16),
    (8, 8)])
def test_blk_for_matches_jax(monkeypatch, blk, w):
    monkeypatch.setattr(pm, "BLK", blk)
    monkeypatch.setattr(cuda_msm, "BLK", blk)
    assert cuda_msm.blk_for(w) == pm.blk_for(w)
    if blk > 0:
        assert cuda_msm._out_lanes(blk) == pm._out_lanes(blk)


@pytest.mark.parametrize("nwin, requested", [
    (6, 4), (52, 8), (52, 16), (26, 16), (26, 4), (7, 4), (52, 4), (52, 13),
    (26, 13), (6, 1), (6, 6)])
def test_group_for_matches_jax(nwin, requested):
    assert cuda_msm.group_for(nwin, requested) == pm.group_for(nwin,
                                                               requested)


def test_loop_blk_takes_any_width(monkeypatch):
    """A width with a legal block keeps it; one without (where the JAX
    package drops to XLA) gets BLK rounded to a power of two, ragged."""
    assert cuda_msm.loop_blk(5120) == 512
    assert cuda_msm.loop_blk(128) == 128
    for w in (8, 16, 160, 192, 320):
        assert pm.blk_for(w) is None
        assert cuda_msm.loop_blk(w) == 512
    monkeypatch.setattr(cuda_msm, "BLK", 384)
    assert cuda_msm.loop_blk(160) == 256
    monkeypatch.setattr(cuda_msm, "BLK", 0)
    with pytest.raises(ValueError):
        cuda_msm.loop_blk(160)


ENGINE_ENV = {"COMETBFT_TPU_PALLAS_MSM_MAJOR": ("USE_PALLAS_MSM_MAJOR", "0"),
              "COMETBFT_TPU_PALLAS_MSM_LOOP": ("USE_PALLAS_MSM_LOOP", "0"),
              "COMETBFT_TPU_PALLAS_TREE": ("USE_PALLAS_TREE", "1"),
              "COMETBFT_TPU_PALLAS_FOLD": ("USE_PALLAS_FOLD", "0")}


def test_engine_flags_read_the_jax_variables(monkeypatch):
    """The port's flags, BLK and WIN_GROUP read the JAX package's
    variables with its defaults, so one environment picks one engine in
    both packages."""
    import importlib

    def reload():
        importlib.reload(cuda_msm)
        importlib.reload(tdev)

    for var in list(ENGINE_ENV) + ["COMETBFT_TPU_PALLAS_BLK",
                                   "COMETBFT_TPU_PALLAS_WIN_GROUP"]:
        monkeypatch.delenv(var, raising=False)
    try:
        reload()
        assert (tdev.USE_PALLAS_MSM_MAJOR, tdev.USE_PALLAS_MSM_LOOP,
                tdev.USE_PALLAS_TREE, tdev.USE_PALLAS_FOLD,
                cuda_msm.BLK, cuda_msm.WIN_GROUP) == \
            (True, True, False, True, 512, 1)
        for var, (flag, value) in ENGINE_ENV.items():
            monkeypatch.setenv(var, value)
        monkeypatch.setenv("COMETBFT_TPU_PALLAS_BLK", "256")
        monkeypatch.setenv("COMETBFT_TPU_PALLAS_WIN_GROUP", "13")
        reload()
        assert (tdev.USE_PALLAS_MSM_MAJOR, tdev.USE_PALLAS_MSM_LOOP,
                tdev.USE_PALLAS_TREE, tdev.USE_PALLAS_FOLD,
                cuda_msm.BLK, cuda_msm.WIN_GROUP) == \
            (False, False, True, False, 256, 13)
    finally:
        monkeypatch.undo()
        reload()
    for var, (flag, _) in ENGINE_ENV.items():
        assert getattr(tdev, flag) == getattr(jdev, flag), flag
    assert (cuda_msm.BLK, cuda_msm.WIN_GROUP) == (pm.BLK, pm.WIN_GROUP)
    assert tdev.NPART_MAX == jdev.NPART_MAX
    assert [tdev._npart(w) for w in (16, 160, 5120, 8192)] == \
        [jdev._npart(w) for w in (16, 160, 5120, 8192)]


def test_auto_engine_is_straus_at_ed25519_widths():
    """The JAX cost model's auto choice, which the port takes as
    Straus, at every width pad_width gives up to 2**17."""
    widths = sorted({tdev.pad_width(n) for n in range(1, 1 << 17, 97)})
    assert {jmsm.choose_engine(w, 5) for w in widths} == {"straus"}


# -- K6 / K7 against the interpret-mode Pallas kernels ------------------------

@pytest.fixture(scope="module")
def loop_case():
    """The inputs and the JAX kernels' partials, computed once: the
    OUT_PER_BLK override is traced into the kernels, so the jit caches
    are cleared around it."""
    tab, mags, negs = _msm_inputs(LOOP_W, LOOP_NWIN, 3)
    jt, jm, jn = jnp.asarray(tab.numpy()), jnp.asarray(mags), jnp.asarray(negs)
    saved = pm.OUT_PER_BLK
    jax.clear_caches()
    pm.OUT_PER_BLK = LOOP_OUT
    try:
        loop = np.asarray(pm.msm_window_loop(jt, jm, jn, interpret=True,
                                             blk=LOOP_BLK))
        tree = [np.asarray(pm.select_tree(jt, jm[j], jn[j], interpret=True,
                                          blk=LOOP_BLK))
                for j in range(LOOP_NWIN)]
    finally:
        pm.OUT_PER_BLK = saved
        jax.clear_caches()
    return tab, mags, negs, loop, tree


def test_window_loop_matches_pallas_kernel_per_lane(loop_case, monkeypatch):
    tab, mags, negs, want, _ = loop_case
    monkeypatch.setattr(cuda_msm, "OUT_PER_BLK", LOOP_OUT)
    got = cuda_msm.msm_window_loop(tab, torch.from_numpy(mags),
                                   torch.from_numpy(negs), blk=LOOP_BLK)
    assert got.shape == want.shape == (4, 20, 2 * LOOP_OUT)
    assert _proj(got.numpy()) == _proj(want)
    assert cuda_msm.msm_window_loop.launches == 0      # CPU: plain only


@pytest.mark.parametrize("j", range(LOOP_NWIN))
def test_select_tree_matches_pallas_kernel_per_lane(loop_case, monkeypatch,
                                                    j):
    """Every digit row, the one with magnitudes 17, 31 and -1 included."""
    tab, mags, negs, _, want = loop_case
    monkeypatch.setattr(cuda_msm, "OUT_PER_BLK", LOOP_OUT)
    got = cuda_msm.select_tree(tab, torch.from_numpy(mags[j]),
                               torch.from_numpy(negs[j]), blk=LOOP_BLK)
    assert got.shape == want[j].shape
    assert _proj(got.numpy()) == _proj(want[j])


def test_window_loop_is_select_tree_recurrence(monkeypatch):
    """K6's partials are K7's window partials run through the Straus
    step, limb for limb, at a ragged 512-lane block (no legal block)."""
    tab, mags, negs = _msm_inputs(24, 3, 9)
    m, n = torch.from_numpy(mags), torch.from_numpy(negs)
    got = cuda_msm.msm_window_loop(tab, m, n)
    assert got.shape == (4, 20, 128)
    acc = cuda_msm.select_tree(tab, m[0], n[0])
    for j in range(1, 3):
        acc = tdev.straus_step(acc, cuda_msm.select_tree(tab, m[j], n[j]))
    assert torch.equal(got, acc)
    with pytest.raises(ValueError):
        cuda_msm.msm_window_loop(tab, m, n, blk=384)


# -- K5: grouped window-major ---------------------------------------------------

def _per_block_order(tab, mags, negs):
    """K5's order: per window, each 32-lane block's pairwise halving tree
    (lanes past W the identity); per block, the windows closed in MSB
    order by the Straus step."""
    nwin, w = mags.shape
    nblk = -(-w // 32)
    acc = None
    for j in range(nwin):
        pts = tdev._cond_neg_point(tdev._select17(tab, torch.from_numpy(
            mags[j])), torch.from_numpy(negs[j]))
        pts = torch.cat([pts, tdev.identity_point((nblk * 32 - w,), "cpu")],
                        dim=-1).reshape(4, 20, nblk, 32)
        sums = tdev._tree_reduce(pts, 1)[..., 0]
        acc = sums if acc is None else tdev.straus_step(acc, sums)
    return acc


@pytest.fixture(scope="module")
def group_case():
    tab, mags, negs = _msm_inputs(GROUP_W, GROUP_NWIN, 17)
    want = jdev._msm_scan(jnp.asarray(tab.numpy()), jnp.asarray(mags),
                          jnp.asarray(negs))
    k3 = cuda_msm.msm_window_major(tab, torch.from_numpy(mags),
                                   torch.from_numpy(negs), group=1)
    return (tab, mags, negs, _proj(np.asarray(want)), k3,
            _per_block_order(tab, mags, negs))


@pytest.mark.parametrize("requested, group", [(2, 2), (3, 3), (4, 3), (6, 6)])
def test_grouped_equals_window_major(group_case, monkeypatch, requested,
                                     group):
    """WIN_GROUP = requested routes msm_window_major to K5 with
    group_for's group (4 degrades to 3 at 6 windows); K5's partials equal
    its per-block order limb for limb, and they and K3's sum to the JAX
    XLA scan."""
    tab, mags, negs, want, k3, k5_order = group_case
    calls = []
    real = cuda_msm.msm_window_major_grouped_plain

    def spy(tab, mags, negs, group):
        calls.append(group)
        return real(tab, mags, negs, group)

    monkeypatch.setattr(cuda_msm, "msm_window_major_grouped_plain", spy)
    monkeypatch.setattr(cuda_msm, "WIN_GROUP", requested)
    got = cuda_msm.msm_window_major(tab, torch.from_numpy(mags),
                                    torch.from_numpy(negs))
    assert calls == [group]
    assert got.shape == (4, 20, 2)
    assert torch.equal(got, k5_order)
    assert _proj(tdev._tree_reduce(got, 1).numpy()) == want
    assert _proj(tdev._tree_reduce(k3, 1).numpy()) == want


def test_window_major_ignores_magnitudes_out_of_range(group_case):
    """Magnitudes 17, 31 and -1 select the identity: the same partials
    as digit 0 there."""
    tab, mags, negs, _, k3, _ = group_case
    zeroed = mags.copy()
    zeroed[1, :3] = 0
    got = cuda_msm.msm_window_major(tab, torch.from_numpy(zeroed),
                                    torch.from_numpy(negs), group=1)
    assert torch.equal(got, k3)
    with pytest.raises(ValueError):
        cuda_msm.msm_window_major_grouped(tab, torch.from_numpy(mags),
                                          torch.from_numpy(negs), 4)


@pytest.mark.slow
def test_grouped_matches_pallas_kernel():
    """K5's plain version against the grouped Pallas kernel in interpret
    mode (minutes per compile on one core): equal lane sums."""
    tab, mags, negs = _msm_inputs(16, 6, 29)
    jt, jm, jn = jnp.asarray(tab.numpy()), jnp.asarray(mags), jnp.asarray(negs)
    for blk, grp in ((8, 4), (16, 2)):
        want = pm.msm_window_major(jt, jm, jn, interpret=True, blk=blk,
                                   group=grp)
        got = cuda_msm.msm_window_major(tab, torch.from_numpy(mags),
                                        torch.from_numpy(negs), group=grp)
        assert _proj(tdev._tree_reduce(got, 1).numpy()) == \
            _proj(jdev._tree_reduce(jnp.asarray(want), 1))


# -- routing and verdicts under every configuration -----------------------------

CONFIGS = {
    "window_major": {},
    "window_loop": {"USE_PALLAS_MSM_MAJOR": False},
    "grouped_g4": {"WIN_GROUP": 4},
    "grouped_g13": {"WIN_GROUP": 13},
    "select_tree": {"USE_PALLAS_MSM_MAJOR": False,
                    "USE_PALLAS_MSM_LOOP": False, "USE_PALLAS_TREE": True},
    "fold_off": {"USE_PALLAS_FOLD": False},
    "plain_scan": {"USE_PALLAS_MSM_MAJOR": False,
                   "USE_PALLAS_MSM_LOOP": False},
}

# plain version -> calls per RLC verify (A side 52 windows, R side 26)
KERNEL_PLAINS = ("msm_window_major_plain", "msm_window_major_grouped_plain",
                 "msm_window_loop_plain", "select_tree_plain",
                 "fold_verify_plain")
EXPECTED_CALLS = {
    "window_major": {"msm_window_major_plain": 2, "fold_verify_plain": 1},
    "window_loop": {"msm_window_loop_plain": 2, "fold_verify_plain": 1},
    "grouped_g4": {"msm_window_major_grouped_plain": 2,
                   "fold_verify_plain": 1},
    "grouped_g13": {"msm_window_major_grouped_plain": 2,
                    "fold_verify_plain": 1},
    "select_tree": {"select_tree_plain": 52 + 26},
    "fold_off": {"msm_window_major_plain": 2},
    "plain_scan": {},
}
GROUPS = {"grouped_g4": [4, 2], "grouped_g13": [13, 13]}


def _apply(monkeypatch, config):
    for name, value in CONFIGS[config].items():
        monkeypatch.setattr(cuda_msm if name == "WIN_GROUP" else tdev, name,
                            value)


def _spy(monkeypatch):
    calls = {name: [] for name in KERNEL_PLAINS}
    for name in KERNEL_PLAINS:
        real = getattr(cuda_msm, name)

        def spy(*args, _name=name, _real=real):
            calls[_name].append(args[3] if _name.startswith(
                "msm_window_major_grouped") else None)
            return _real(*args)

        monkeypatch.setattr(cuda_msm, name, spy)
    return calls


@pytest.fixture(scope="module")
def rlc_case():
    """Ten signatures under ten keys (K = 16, N = 16: the shape of the
    JAX suite's RLC program test, test_ed25519.py::test_rlc_batch_equation),
    clean and with one tampered signature, and the JAX program's
    verdicts on both."""
    rng = np.random.default_rng(41)
    pks, msgs, sigs = [], [], []
    for i in range(10):
        k = ted.PrivKey.generate(rng.bytes(32))
        m = rng.bytes(30 + i)
        pks.append(k.pub_key().bytes())
        msgs.append(m)
        sigs.append(k.sign(m))
    bad = list(sigs)
    bad[6] = bad[6][:7] + bytes([bad[6][7] ^ 0x10]) + bad[6][8:]
    cases = {}
    for label, s in (("accept", sigs), ("tampered", bad)):
        packed = ted.pack_rlc(pks, msgs, s)
        cases[label] = (packed, bool(np.asarray(jdev.rlc_verify_device(
            *packed))))
    assert cases["accept"][0][0].shape == (8, 16)
    assert cases["accept"][0][1].shape == (8, 16)
    assert [v for _, v in cases.values()] == [True, False]
    return cases


@pytest.mark.parametrize("config", list(CONFIGS))
def test_rlc_routes_and_verdicts(rlc_case, monkeypatch, config):
    """Each configuration calls exactly its kernels' wrappers (seen
    through their plain versions, which the CPU runs), and both RLC
    programs return the JAX program's verdicts, at widths 16 with no
    legal block (BLK 512: ragged blocks) and with one (BLK 8)."""
    _apply(monkeypatch, config)
    calls = _spy(monkeypatch)
    for blk in (512, 8):
        monkeypatch.setattr(cuda_msm, "BLK", blk)
        for label, (packed, want) in rlc_case.items():
            t = convert.packed_from_numpy(packed, "cpu")
            for name in calls:
                calls[name].clear()
            got = tdev.rlc_verify_kernel(*t)
            assert got.dim() == 0 and bool(got) is want, (blk, label)
            assert {k: len(v) for k, v in calls.items() if v} == \
                EXPECTED_CALLS[config], (blk, label)
            if config in GROUPS:
                assert calls["msm_window_major_grouped_plain"] == \
                    GROUPS[config]
            if blk == 512:
                tab, ok = tdev.build_a_tables(t[0])
                got = tdev.rlc_verify_kernel_cached_a(tab, ok, *t[1:])
                assert bool(got) is want, ("cached_a", label)


def test_msm_is_tables_then_scan(rlc_case):
    """_msm: one side's decompression (K1), tables (K2) and scan."""
    t = convert.packed_from_numpy(rlc_case["accept"][0], "cpu")
    point, ok = tdev._msm(t[1], t[4], t[5])
    tab, ok_t = tdev.build_a_tables(t[1])
    assert bool(ok) and bool(ok_t)
    assert torch.equal(point, tdev._msm_scan(tab, t[4], t[5]))


def test_bucket_engine_raises(rlc_case, monkeypatch):
    """The bucket engine is not ported: asking for it raises in the fused
    and the non-fused programs alike, and Straus never runs in its
    place."""
    t = convert.packed_from_numpy(rlc_case["accept"][0], "cpu")
    calls = _spy(monkeypatch)
    monkeypatch.setenv("COMETBFT_TPU_MSM_ENGINE", "bucket")
    for config in ("window_major", "fold_off", "plain_scan"):
        _apply(monkeypatch, config)
        with pytest.raises(NotImplementedError, match="bucket"):
            tdev.rlc_verify_kernel(*t)
    assert not any(calls.values())
    monkeypatch.setenv("COMETBFT_TPU_MSM_ENGINE", "straus")
    assert bool(tdev.rlc_verify_kernel(*t))
