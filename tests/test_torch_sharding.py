"""The port's multi-device ops layer on the CPU: ops/sharding.py and
K8 (ops/msm_shard.py: sharded_msm, rlc_verify_sharded) against the JAX
package on its 8-virtual-device mesh (tests/conftest.py), against the
pure-Python oracle and against the port's own unsharded programs.

The port's device lists here name "cpu" several times: each shard runs
its plain versions in turn on the host, as logical shards on one card
run their kernels in turn.  Tolerance: exact — the same bucket and
device choices, the same verdicts, points equal at canonical (affine)
values, gathered partials equal limb for limb."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import ed25519 as jdev
from cometbft_tpu.ops import msm_shard as jshard
from cometbft_tpu.ops import sharding as jsharding
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import ed25519_ref as tref
from cometbft_tpu_torch.ops import cuda_msm
from cometbft_tpu_torch.ops import ed25519 as tdev
from cometbft_tpu_torch.ops import fe as tfe
from cometbft_tpu_torch.ops import msm_shard
from cometbft_tpu_torch.ops import sharding

CPU = torch.device("cpu")
MSM_W, MSM_NWIN = 32, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions run thousands of small torch ops; beside other
    busy test workers, OpenMP's threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _items(n, seed=42, bad=()):
    """n (pubkey, msg, sig) with distinct keys; indices in `bad` get a
    signature with one bit of R flipped."""
    out = []
    for i in range(n):
        priv = ted.PrivKey.generate(bytes([seed, i & 0xFF, i >> 8])
                                    + b"\x05" * 29)
        m = b"mesh-item" + i.to_bytes(4, "little")
        sig = priv.sign(m)
        if i in bad:
            sig = sig[:6] + bytes([sig[6] ^ 1]) + sig[7:]
        out.append((priv.pub_key().bytes(), m, sig))
    return out


def _affine(pt):
    """(4, 20, n) limbs -> per lane (x, y) affine Python ints."""
    pt = np.asarray(pt)
    out = []
    for i in range(pt.shape[-1]):
        x, y, z = (tfe.limbs_to_int(pt[c, :, i]) for c in range(3))
        zi = pow(z, tfe.P - 2, tfe.P)
        out.append((x * zi % tfe.P, y * zi % tfe.P))
    return out


# -- ops/sharding.py -------------------------------------------------------------

@pytest.mark.parametrize("n_devices", [1, 2, 3, 6, 8])
def test_auto_bucket_matches_jax(n_devices):
    for n in list(range(1, 70)) + [255, 256, 257, 1000, 4095, 16385]:
        assert sharding.auto_bucket(n, n_devices) == \
            jsharding.auto_bucket(n, n_devices), (n, n_devices)


@pytest.mark.parametrize("setting", [None, "0", "1", "2", "16"])
def test_mesh_device_list_matches_jax(monkeypatch, setting):
    """COMETBFT_TPU_MESH_DEVICES as the JAX package reads it, with the
    port seeing 8 cards as the JAX package sees 8 virtual devices."""
    monkeypatch.setattr(sharding, "device_count", lambda: 8)
    if setting is None:
        monkeypatch.delenv("COMETBFT_TPU_MESH_DEVICES", raising=False)
    else:
        monkeypatch.setenv("COMETBFT_TPU_MESH_DEVICES", setting)
    assert len(jax.devices()) == 8

    def ids(devs, attr):
        return None if devs is None else [getattr(d, attr) for d in devs]

    for k in (None, 0, 1, 3, 64):
        got = sharding.mesh_device_list(k)
        assert ids(got, "index") == ids(jsharding.mesh_device_list(k), "id")
        assert got is None or all(d.type == "cuda" for d in got)


def test_verify_batch_sharded_splits_and_gathers(monkeypatch):
    """Two shards: one per-signature program per shard on its lanes, the
    verdicts gathered in order, equal to one unsharded program and to
    the oracle; a width the device count does not divide runs one
    program."""
    items = _items(16, bad=(3, 12))
    pks = [i[0] for i in items]
    parsed = ted.parse_and_hash(pks, [i[1] for i in items],
                                [i[2] for i in items])
    a, r, s, h, valid = ted.pack_batch(pks, [b""] * 16, [b""] * 16, 16,
                                       parsed=parsed)
    widths = []
    persig = tdev.verify_kernel

    def spy(*args):
        widths.append(int(args[0].shape[-1]))
        return persig(*args)

    monkeypatch.setattr(tdev, "verify_kernel", spy)
    split = sharding.verify_batch_sharded(a, r, s, h, devices=[CPU, CPU])
    assert widths == [8, 8]
    single = sharding.verify_batch_sharded(a, r, s, h, devices=[CPU] * 3)
    assert widths == [8, 8, 16]
    assert split.tolist() == single.tolist()
    want = [tref.verify(*it) for it in items]
    assert (split.numpy() & valid).tolist() == want
    assert [i for i, v in enumerate(want) if not v] == [3, 12]


# -- K8: sharded_msm -------------------------------------------------------------

@pytest.fixture(scope="module")
def msm_case():
    """Tables of 32 distinct keys (the port's plain K1/K2, limb-equal to
    the JAX package's), seeded digits with magnitudes 0..16 over 4
    windows, and the JAX package's points for them: sharded_msm with the
    XLA scan per shard over its 8-device mesh, and the unsharded
    _msm_scan — __graft_entry__.dryrun_multichip's phase 4."""
    enc = np.stack([np.frombuffer(pk, dtype="<u4")
                    for pk, _, _ in _items(MSM_W, seed=9)], axis=1)
    tab, ok = tdev.build_a_tables(convert.words_from_numpy(enc, CPU))
    assert bool(ok)
    rng = np.random.default_rng(17)
    mags = rng.integers(0, 17, (MSM_NWIN, MSM_W), dtype=np.int32)
    negs = rng.integers(0, 2, (MSM_NWIN, MSM_W)) != 0
    jtab, jmags, jnegs = (jnp.asarray(x) for x in (tab.numpy(), mags, negs))
    # jitted: shard_map run eagerly compiles op by op (minutes)
    j_sharded = jax.jit(functools.partial(
        jshard.sharded_msm, mesh=jsharding._mesh(),
        use_pallas=False))(jtab, jmags, jnegs)
    j_scan = jdev._msm_scan(jtab, jmags, jnegs)
    return (tab, torch.from_numpy(mags), torch.from_numpy(negs),
            _affine(j_sharded), _affine(j_scan))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_msm_matches_jax(msm_case, n):
    tab, mags, negs, j_sharded, j_scan = msm_case
    got = msm_shard.sharded_msm(tab, mags, negs, devices=[CPU] * n)
    assert got.shape == (4, tfe.NLIMBS, 1)
    assert _affine(got) == j_sharded == j_scan


def test_sharded_partials_keep_shard_order(msm_case):
    """The gather is each shard's K3 partials, in device order, limb for
    limb; their lane sum is the single-program K3 point."""
    tab, mags, negs, _, j_scan = msm_case
    parts = msm_shard.sharded_partials(tab, mags, negs, devices=[CPU] * 4)
    step = MSM_W // 4
    want = torch.cat([cuda_msm.msm_window_major_plain(
        tab[..., i:i + step], mags[:, i:i + step], negs[:, i:i + step])
        for i in range(0, MSM_W, step)], dim=-1)
    assert torch.equal(parts, want)
    whole = tdev._tree_reduce(cuda_msm.msm_window_major(tab, mags, negs), 1)
    assert _affine(tdev._tree_reduce(parts, 1)) == _affine(whole) == j_scan


def test_width_the_devices_do_not_divide_raises(msm_case):
    tab, mags, negs, _, _ = msm_case
    with pytest.raises(ValueError):
        msm_shard.sharded_msm(tab, mags, negs, devices=[CPU] * 3)
    with pytest.raises(ValueError):
        msm_shard.sharded_msm(tab, mags, negs, devices=[])
    packed = ted.pack_rlc(*zip(*_items(16)))        # K = 32, N = 16
    t = convert.packed_from_numpy(packed, CPU)
    with pytest.raises(ValueError):
        msm_shard.rlc_verify_sharded(*t, devices=[CPU] * 3)
    with pytest.raises(ValueError):                 # A divides, R does not
        msm_shard.rlc_verify_sharded(*t, devices=[CPU] * 32)
    assert msm_shard.sharded_msm.launches == 0      # CPU shards count none


# -- K8: rlc_verify_sharded ------------------------------------------------------

@pytest.fixture(scope="module")
def rlc_case():
    """16 signatures (A side 32 lanes, R side 16), clean and with index
    7 tampered, packed with fixed weights."""
    out = {}
    for label, bad in (("clean", ()), ("bad", (7,))):
        items = _items(16, bad=bad)
        packed = ted.pack_rlc(*zip(*items), z=range(1, 17))
        out[label] = (convert.packed_from_numpy(packed, CPU),
                      all(tref.verify(*it) for it in items))
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("label", ["clean", "bad"])
def test_rlc_verify_sharded_verdicts(rlc_case, monkeypatch, n, label):
    """The verdict equals the oracle's and the unsharded program's; per
    shard, tables and K3 on both sides, then one fold."""
    t, want = rlc_case[label]
    calls = {"k3": 0, "fold": 0}
    k3, fold = cuda_msm.msm_window_major, cuda_msm.fold_verify

    def k3_spy(*a, **k):
        calls["k3"] += 1
        return k3(*a, **k)

    def fold_spy(*a, **k):
        calls["fold"] += 1
        return fold(*a, **k)

    monkeypatch.setattr(cuda_msm, "msm_window_major", k3_spy)
    monkeypatch.setattr(cuda_msm, "fold_verify", fold_spy)
    got = msm_shard.rlc_verify_sharded(*t, devices=[CPU] * n)
    assert calls == {"k3": 2 * n, "fold": 1}
    assert got.shape == () and bool(got) is want is (label == "clean")
    assert bool(tdev.rlc_verify_kernel(*t)) is want
