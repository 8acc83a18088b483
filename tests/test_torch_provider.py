"""COMETBFT_TPU_PROVIDER and create_batch_verifier's provider= argument in
the port, against the JAX package's choice.

"cpu" is the host loop at any size, "tpu" the device programs at any
size, and "auto" (or unset) picks by n_hint against DEVICE_THRESHOLD.
The threshold is read at import, so the port's crypto/batch is reloaded
under each setting and the JAX package's choice comes from a private
copy of its module loaded under the same setting."""

import importlib
import importlib.util
import sys
from pathlib import Path

import pytest

import cometbft_tpu
from cometbft_tpu_torch.crypto import batch as tbatch

# the host loop, or the device programs (CUDA in the port, XLA in JAX)
KIND = {"CpuEd25519BatchVerifier": "host",
        "CudaEd25519BatchVerifier": "device",
        "TpuEd25519BatchVerifier": "device"}


def _jax_batch(monkeypatch):
    path = Path(cometbft_tpu.__file__).parent / "crypto" / "batch.py"
    full = "cometbft_tpu.crypto.batch_envcopy"
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, full, mod)
    spec.loader.exec_module(mod)
    return mod


def _kinds(create, hints, **kw):
    return [KIND[type(create("ed25519", n, **kw)).__name__] for n in hints]


@pytest.mark.parametrize("threshold", ["unset", "20"])
@pytest.mark.parametrize("env", ["unset", "cpu", "tpu", "auto"])
@pytest.mark.parametrize("arg", [None, "cpu", "tpu", "auto"])
def test_provider_picks_the_jax_package_verifier(monkeypatch, env, arg,
                                                 threshold):
    for var, value in (("COMETBFT_TPU_PROVIDER", env),
                       ("COMETBFT_TPU_BATCH_THRESHOLD", threshold)):
        monkeypatch.delenv(var, raising=False)
        if value != "unset":
            monkeypatch.setenv(var, value)
    try:
        importlib.reload(tbatch)
        t = tbatch.DEVICE_THRESHOLD
        hints = [0, 1, t - 1, t, t + 1, 10_000]
        port = _kinds(tbatch.create_batch_verifier, hints, device="cpu",
                      provider=arg)
        jb = _jax_batch(monkeypatch)
        assert jb.DEVICE_THRESHOLD == t
        jax_side = _kinds(jb.create_batch_verifier, hints, provider=arg)
    finally:
        monkeypatch.undo()
        importlib.reload(tbatch)
    assert port == jax_side
    provider = arg or (env if env != "unset" else "auto")
    if provider == "cpu":
        assert port == ["host"] * len(hints)
    elif provider == "tpu":
        assert port == ["device"] * len(hints)
    else:
        assert port == ["device", "host", "host", "device", "device",
                        "device"]


def test_device_programs_run_on_the_given_device():
    bv = tbatch.create_batch_verifier("ed25519", 1, device="cpu",
                                      provider="tpu")
    assert isinstance(bv, tbatch.CudaEd25519BatchVerifier)
    assert str(bv.device) == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatch.create_batch_verifier("ed25519", 1, provider="cpu")
