"""The port's device-health circuit breaker (crypto/devhealth.py) against
the JAX package's: the same fault / hang / ok / probe sequences under the
same fake clock walk both registries through the same states with the
same backoffs, recoveries, metrics and flight-recorder events.  Also the
known-answer probe batch, and the mesh split filtered through the
registry (crypto/mesh._healthy_devices)."""

import gc
import random

import pytest

from cometbft_tpu.crypto import devhealth as jdevhealth
from cometbft_tpu.crypto import ed25519_ref as jref
from cometbft_tpu.crypto import mesh as jmesh
from cometbft_tpu.libs import flightrec as jflightrec
from cometbft_tpu.libs import metrics as jmetrics
from cometbft_tpu_torch.crypto import devhealth, mesh
from cometbft_tpu_torch.libs import flightrec
from cometbft_tpu_torch.libs import lockrank as plr
from cometbft_tpu_torch.libs import metrics

SIDES = ((devhealth, flightrec, metrics),
         (jdevhealth, jflightrec, jmetrics))


@pytest.fixture(scope="module", autouse=True)
def _frozen_heap():
    """Move the objects alive after the imports (torch's, JAX's) out of
    the collector's reach for this module: the per-test gc.collect() of
    the leak checks then walks only what the tests made."""
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()


@pytest.fixture(autouse=True)
def _port_lock_ranks():
    plr.enable("raise")
    yield
    assert plr.violations() == []
    plr.disable()


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _walk(mod, fr, mt, ops, **kw):
    """Feed `ops` to a registry under a fake clock with metrics and a
    flight recorder installed: every answer, state and snapshot."""
    clk = FakeClock()
    reg = mod.HealthRegistry(clock=clk, **kw)
    rec, mreg = fr.FlightRecorder(clock=clk), mt.Registry("cometbft_tpu")
    fr.set_recorder(rec)
    mt.set_device_metrics(mt.DeviceMetrics(mreg))
    trace = []
    try:
        for op, dev, arg in ops:
            if op == "tick":
                clk.t += arg
                continue
            if op == "fault":
                out = reg.note_fault(dev, reason=arg)
            elif op == "hang":
                out = reg.note_hang(dev)
            elif op == "ok":
                out = reg.note_ok(dev)
            elif op == "due":
                out = reg.due_probe(dev)
            else:
                out = reg.probe_result(dev, arg) \
                    if reg.state(dev) == mod.HEALTH_PROBING else None
            trace.append((op, dev, out, reg.state(dev), reg.usable(dev),
                          reg.all_quarantined(["0", "1"])))
        trace.append(("end", reg.snapshot(), reg.dump_text(),
                      {d: (reg.quarantines(d), reg.recovery_seconds(d))
                       for d in ("0", "1")}))
    finally:
        fr.set_recorder(None)
        mt.set_device_metrics(None)
    return trace, rec.events(), mreg.expose()


def _ops(seed, n=120):
    rng = random.Random(seed)
    ops = []
    for _ in range(n):
        dev = rng.choice(("0", "1"))
        r = rng.random()
        if r < 0.3:
            ops.append(("fault", dev, rng.choice(("RuntimeError",
                                                  "fault"))))
        elif r < 0.37:
            ops.append(("hang", dev, None))
        elif r < 0.5:
            ops.append(("ok", dev, None))
        elif r < 0.7:
            ops.append(("due", dev, None))
        elif r < 0.8:
            ops.append(("probe", dev, rng.choice(("ok", "fail"))))
        else:
            ops.append(("tick", dev, rng.choice((0.1, 0.6, 2.0, 11.0))))
    return ops


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("config", [
    {}, {"quarantine_after": 1, "probe_backoff_s": 0.5,
         "probe_backoff_max_s": 2.0},
    {"quarantine_after": 3, "fault_window_s": 10.0, "probe_backoff_s": 1.0,
     "probe_backoff_max_s": 4.0}])
def test_state_walk_matches(seed, config):
    ops = _ops(seed)
    port = _walk(*SIDES[0], ops, **config)
    assert port == _walk(*SIDES[1], ops, **config)
    states = {t[3] for t in port[0][:-1]}
    assert states <= devhealth.HEALTH_STATES


def test_probe_cycle_backoff_and_recovery():
    """JAX package's probe cycle: backoff gates the probe, a failure
    doubles it up to the cap, recovery is timed from the first
    quarantine, and the backoff resets."""
    clk = FakeClock()
    reg = devhealth.HealthRegistry(quarantine_after=3, fault_window_s=10.0,
                                   probe_backoff_s=1.0,
                                   probe_backoff_max_s=4.0, clock=clk)
    reg.note_hang("0")
    assert not reg.due_probe("0")
    backoffs = []
    for _ in range(4):
        clk.t += 10.0
        assert reg.due_probe("0") and not reg.due_probe("0")
        reg.probe_result("0", "fail")
        backoffs.append(reg.snapshot()["0"]["backoff_s"])
    assert backoffs == [2.0, 4.0, 4.0, 4.0]
    clk.t += 10.0
    assert reg.due_probe("0")
    reg.probe_result("0", "ok")
    assert reg.state("0") == devhealth.HEALTH_HEALTHY
    assert reg.recovery_seconds("0") == [pytest.approx(50.0)]
    assert reg.quarantines("0") == 1
    with pytest.raises(ValueError):
        reg.transition("0", "limping")
    with pytest.raises(ValueError):
        reg.probe_result("0", "maybe")


def test_probe_items_are_the_jax_packages_and_its_reference_verdicts():
    """The port signs its probe batch with its own keys: the same bytes
    as the JAX package's, and the JAX package's ed25519_ref gives exactly
    probe_expected() on them (all-true fails the corrupted lane)."""
    items = devhealth.probe_items()
    jitems = jdevhealth.probe_items()
    assert [(pk.bytes(), m, s) for pk, m, s in items] == \
        [(pk.bytes(), m, s) for pk, m, s in jitems]
    got = [jref.verify(pk.bytes(), m, s) for pk, m, s in items]
    assert got == devhealth.probe_expected() == jdevhealth.probe_expected()
    assert devhealth.probe_items() is items          # built once


def test_registry_seam():
    prev = devhealth.registry()
    reg = devhealth.HealthRegistry()
    try:
        devhealth.set_registry(reg)
        assert devhealth.registry() is reg
    finally:
        devhealth.set_registry(prev)
    assert devhealth.registry() is prev


@pytest.mark.parametrize("benched", [(), ("1",), ("0", "2"),
                                     ("0", "1", "2", "3")])
def test_mesh_split_skips_quarantined_devices_as_the_jax_package(benched):
    """crypto/mesh._healthy_devices: with device "1" (or others)
    quarantined in both packages' process registries, the same split
    list; every device benched (brownout) or no registry: the full
    list."""
    devices = ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    prev = (devhealth.registry(), jdevhealth.registry())
    try:
        assert mesh._healthy_devices(devices) == devices
        regs = (devhealth.HealthRegistry(), jdevhealth.HealthRegistry())
        for reg in regs:
            for d in benched:
                reg.note_hang(d)
        devhealth.set_registry(regs[0])
        jdevhealth.set_registry(regs[1])
        got = mesh._healthy_devices(devices)
        assert got == jmesh._healthy_devices(devices)
        if len(benched) == len(devices):
            assert got == devices
        else:
            assert got == [d for i, d in enumerate(devices)
                           if str(i) not in benched]
    finally:
        devhealth.set_registry(prev[0])
        jdevhealth.set_registry(prev[1])
