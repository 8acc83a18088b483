"""Per-device health state machine: the port's copy of
`cometbft_tpu.crypto.devhealth`, the verify plane's circuit breaker.

Each device walks

    HEALTHY --fault--> SUSPECT --fault-rate/hang--> QUARANTINED
       ^                                                |
       |                                       backoff expired
       +------- probe ok ------- PROBING <--------------+
                                    |
                                    +-- probe fail --> QUARANTINED
                                        (backoff doubles)

- HEALTHY: in rotation.  SUSPECT: a recent fault inside
  ``fault_window_s``; still in rotation (one transient error must not
  eject a device).
- QUARANTINED: ``quarantine_after`` faults inside the window, or one
  hang.  Out of rotation: the pipeline routes this device's windows to
  the host and round-robins new windows onto healthy devices.
- PROBING: a known-answer probe batch (``probe_items``) is in flight.
  Probes are the only device traffic a quarantined device sees,
  scheduled with exponential backoff (``probe_backoff_s`` doubling to
  ``probe_backoff_max_s``).  A probe passes only when the verdict
  vector equals ``probe_expected`` exactly: a device that answers
  all-true fails the deliberately corrupted lane, one that faults
  raises.

On a CUDA card a sticky error (an illegal address) poisons the
process's context: every later dispatch faults, the pipeline drains to
the host, the probes fail and the pipeline enters brownout.  That is
this contract, as in the JAX package.

Every transition drives DeviceMetrics (device_health_state gauge,
device_quarantines_total, device_probes_total) and the flight recorder
(EV_DEVICE_QUARANTINE / EV_DEVICE_PROBE).
"""

from __future__ import annotations

import time

from ..libs import lockrank

HEALTH_HEALTHY = "healthy"
HEALTH_SUSPECT = "suspect"
HEALTH_QUARANTINED = "quarantined"
HEALTH_PROBING = "probing"
# closed registries: every literal state and probe result
HEALTH_STATES = frozenset({"healthy", "suspect", "quarantined",
                           "probing"})
PROBE_OK = "ok"
PROBE_FAIL = "fail"
PROBE_RESULTS = frozenset({"ok", "fail"})

# numeric codes for the device_health_state gauge (dashboards alert on
# `>= 2`: quarantined or probing = out of rotation)
STATE_CODES = {HEALTH_HEALTHY: 0, HEALTH_SUSPECT: 1,
               HEALTH_QUARANTINED: 2, HEALTH_PROBING: 3}

DEFAULT_QUARANTINE_AFTER = 3
DEFAULT_FAULT_WINDOW_S = 30.0
DEFAULT_PROBE_BACKOFF_S = 0.5
DEFAULT_PROBE_BACKOFF_MAX_S = 30.0


class _DeviceRecord:
    __slots__ = ("state", "fault_times", "quarantines", "probes_ok",
                 "probes_failed", "backoff_s", "next_probe_at",
                 "last_quarantine_t", "recovery_seconds", "last_reason")

    def __init__(self, backoff_s: float):
        self.state = HEALTH_HEALTHY
        self.fault_times: list[float] = []
        self.quarantines = 0
        self.probes_ok = 0
        self.probes_failed = 0
        self.backoff_s = backoff_s
        self.next_probe_at = 0.0
        self.last_quarantine_t: float | None = None
        # quarantine-entry -> probe-ok durations (newest last)
        self.recovery_seconds: list[float] = []
        self.last_reason: str | None = None


class HealthRegistry:
    """Thread-safe per-device state machine (module docstring).

    Devices are keyed by the pipeline's device string ("0", "1", ...).
    The clock is injectable so tests drive transitions without
    sleeping.  Methods never call back into the pipeline — the
    pipeline holds its own condition variable while consulting this
    registry, so the lock order is always pipeline-cv -> registry."""

    def __init__(self, quarantine_after: int | None = None,
                 fault_window_s: float | None = None,
                 probe_backoff_s: float | None = None,
                 probe_backoff_max_s: float | None = None,
                 clock=time.monotonic):
        self.quarantine_after = max(1, quarantine_after
                                    if quarantine_after is not None
                                    else DEFAULT_QUARANTINE_AFTER)
        self.fault_window_s = (fault_window_s
                               if fault_window_s is not None
                               else DEFAULT_FAULT_WINDOW_S)
        self.probe_backoff_s = (probe_backoff_s
                                if probe_backoff_s is not None
                                else DEFAULT_PROBE_BACKOFF_S)
        self.probe_backoff_max_s = (probe_backoff_max_s
                                    if probe_backoff_max_s is not None
                                    else DEFAULT_PROBE_BACKOFF_MAX_S)
        self._clock = clock
        # RLock: the note_*/probe_result entry points hold it while
        # funneling through transition()
        self._mtx = lockrank.RankedRLock("devhealth.registry")
        self._recs: dict[str, _DeviceRecord] = {}

    def _rec(self, device: str) -> _DeviceRecord:
        r = self._recs.get(device)
        if r is None:
            r = self._recs[device] = _DeviceRecord(self.probe_backoff_s)
        return r

    # -- queries -----------------------------------------------------------

    def state(self, device: str) -> str:
        with self._mtx:
            r = self._recs.get(device)
            return r.state if r is not None else HEALTH_HEALTHY

    def usable(self, device: str) -> bool:
        """In rotation for real traffic: healthy or suspect.  A
        quarantined/probing device sees only probe batches."""
        return self.state(device) in (HEALTH_HEALTHY, HEALTH_SUSPECT)

    def all_quarantined(self, devices) -> bool:
        """Every listed device out of rotation — the pipeline's
        brownout predicate."""
        devices = list(devices)
        if not devices:
            return False
        return all(not self.usable(d) for d in devices)

    def quarantines(self, device: str) -> int:
        with self._mtx:
            r = self._recs.get(device)
            return r.quarantines if r is not None else 0

    def recovery_seconds(self, device: str) -> list[float]:
        """Quarantine-entry -> probe-ok durations, newest last."""
        with self._mtx:
            r = self._recs.get(device)
            return list(r.recovery_seconds) if r is not None else []

    def snapshot(self) -> dict:
        """Introspection dump: per-device state + counters."""
        with self._mtx:
            now = self._clock()
            return {dev: {"state": r.state,
                          "faults_in_window": len(
                              [t for t in r.fault_times
                               if now - t <= self.fault_window_s]),
                          "quarantines": r.quarantines,
                          "probes_ok": r.probes_ok,
                          "probes_failed": r.probes_failed,
                          "backoff_s": r.backoff_s,
                          "recovery_seconds":
                              list(r.recovery_seconds),
                          "last_reason": r.last_reason}
                    for dev, r in sorted(self._recs.items())}

    def dump_text(self) -> str:
        lines = ["devhealth: per-device circuit breaker state", ""]
        snap = self.snapshot()
        if not snap:
            lines.append("  (no devices tracked)")
        for dev, s in snap.items():
            lines.append(
                "  dev %s: %-11s quarantines=%d probes=%d/%d "
                "faults_in_window=%d backoff=%.2fs%s" % (
                    dev, s["state"], s["quarantines"], s["probes_ok"],
                    s["probes_ok"] + s["probes_failed"],
                    s["faults_in_window"], s["backoff_s"],
                    (" reason=%s" % s["last_reason"])
                    if s["last_reason"] else ""))
        return "\n".join(lines)

    # -- transitions -------------------------------------------------------

    def note_ok(self, device: str) -> None:
        """A real window dispatched clean on this device.  SUSPECT
        clears back to HEALTHY once the fault window has drained —
        interleaved successes never mask a flap's fault rate."""
        with self._mtx:
            r = self._recs.get(device)
            if r is None or r.state != HEALTH_SUSPECT:
                return
            now = self._clock()
            r.fault_times = [t for t in r.fault_times
                             if now - t <= self.fault_window_s]
            if not r.fault_times:
                self.transition(device, "healthy")

    def note_fault(self, device: str, reason: str = "fault") -> bool:
        """A device dispatch raised.  Returns True when this fault
        tripped the breaker (the device just quarantined)."""
        with self._mtx:
            r = self._rec(device)
            if r.state in (HEALTH_QUARANTINED, HEALTH_PROBING):
                return False
            now = self._clock()
            r.fault_times = [t for t in r.fault_times
                             if now - t <= self.fault_window_s]
            r.fault_times.append(now)
            r.last_reason = reason
            if len(r.fault_times) >= self.quarantine_after:
                self.transition(device, "quarantined", reason=reason)
                return True
            if r.state == HEALTH_HEALTHY:
                self.transition(device, "suspect", reason=reason)
            return False

    def note_hang(self, device: str) -> None:
        """The watchdog caught a dispatch past its deadline: straight
        to quarantine — a wedged chip gets no second fault."""
        with self._mtx:
            r = self._rec(device)
            r.last_reason = "hang"
            if r.state != HEALTH_QUARANTINED:
                self.transition(device, "quarantined", reason="hang")

    def due_probe(self, device: str) -> bool:
        """Quarantined and past its backoff: claim the probe slot
        (transitions to PROBING) and return True.  The caller MUST
        follow up with probe_result()."""
        with self._mtx:
            r = self._recs.get(device)
            if r is None or r.state != HEALTH_QUARANTINED:
                return False
            if self._clock() < r.next_probe_at:
                return False
            self.transition(device, "probing")
            return True

    def probe_result(self, device: str, result: str) -> None:
        """Verdict of a known-answer probe batch: "ok" returns the
        device to rotation and resets its backoff; "fail" doubles the
        backoff and re-quarantines."""
        if result not in PROBE_RESULTS:
            raise ValueError("unknown probe result %r" % (result,))
        with self._mtx:
            r = self._rec(device)
            now = self._clock()
            if result == PROBE_OK:
                r.probes_ok += 1
                r.fault_times = []
                r.backoff_s = self.probe_backoff_s
                if r.last_quarantine_t is not None:
                    r.recovery_seconds.append(
                        now - r.last_quarantine_t)
                    r.last_quarantine_t = None
                self.transition(device, "healthy")
            else:
                r.probes_failed += 1
                r.backoff_s = min(r.backoff_s * 2.0,
                                  self.probe_backoff_max_s)
                self.transition(device, "quarantined",
                                reason="probe_fail")
            self._record_probe(device, result, r.backoff_s)

    def transition(self, device: str, state: str,
                   reason: str | None = None) -> None:
        """Canonical transition funnel: every state change lands here,
        driving the health gauge, the quarantine counter and the
        flightrec breadcrumb.  Call sites pass LITERAL states so the
        check_metrics rule-7 lint sees them."""
        if state not in HEALTH_STATES:
            raise ValueError("unknown health state %r" % (state,))
        with self._mtx:
            r = self._rec(device)
            old = r.state
            if old == state:
                return
            r.state = state
            now = self._clock()
            fresh = False
            if state == HEALTH_QUARANTINED:
                # re-entry from a failed probe keeps the doubled
                # backoff and the original outage start; only a fresh
                # outage (from rotation) resets them
                fresh = old in (HEALTH_HEALTHY, HEALTH_SUSPECT)
                if fresh:
                    r.quarantines += 1
                    r.last_quarantine_t = now
                    r.backoff_s = self.probe_backoff_s
                r.next_probe_at = now + r.backoff_s
            self._record_transition(device, old, state, reason, fresh,
                                    r.backoff_s)

    # -- observability -----------------------------------------------------

    def _record_transition(self, device: str, old: str, state: str,
                           reason: str | None, fresh: bool,
                           backoff_s: float) -> None:
        from ..libs import flightrec
        from ..libs import metrics as libmetrics

        dm = libmetrics.device_metrics()
        if dm is not None:
            dm.health_state.labels(device).set(STATE_CODES[state])
            if state == HEALTH_QUARANTINED and fresh:
                dm.quarantines.labels(device).inc()
        if state == HEALTH_QUARANTINED:
            flightrec.record(flightrec.EV_DEVICE_QUARANTINE,
                             device=device, prev=old,
                             reason=reason or "fault_rate",
                             fresh=fresh,
                             backoff_s=round(backoff_s, 4))

    def _record_probe(self, device: str, result: str,
                      backoff_s: float) -> None:
        from ..libs import flightrec
        from ..libs import metrics as libmetrics

        dm = libmetrics.device_metrics()
        if dm is not None:
            dm.probes.labels(device, result).inc()
        flightrec.record(flightrec.EV_DEVICE_PROBE, device=device,
                         result=result, backoff_s=round(backoff_s, 4))


# -- known-answer probe batch -------------------------------------------------

# small enough that a probe is one cheap dispatch; >= 2 lanes so the
# RLC path (not just the per-signature kernel) is exercised, and the
# last lane is deliberately corrupted so a FORGING device (all-true
# without verifying) fails the probe just like a dead one
_PROBE_N = 4
_probe_cache = None


def probe_items():
    """Deterministic (pubkey, msg, sig) probe triples: _PROBE_N - 1
    valid signatures plus one corrupted lane.  Built once per process
    (pure-python signing), never inserted into the verdict cache by
    the pipeline's probe path."""
    global _probe_cache
    if _probe_cache is None:
        from .ed25519 import PrivKey

        items = []
        for i in range(_PROBE_N):
            priv = PrivKey.generate(bytes([0xD0 + i]) * 32)
            msg = b"devhealth-probe-%d" % i
            sig = priv.sign(msg)
            if i == _PROBE_N - 1:
                sig = sig[:4] + bytes([sig[4] ^ 0x55]) + sig[5:]
            items.append((priv.pub_key(), msg, sig))
        _probe_cache = tuple(items)
    return _probe_cache


def probe_expected() -> list[bool]:
    """The exact verdict vector a healthy device must return for
    probe_items() — anything else (including all-true) fails."""
    return [True] * (_PROBE_N - 1) + [False]


# -- process-wide seam --------------------------------------------------------

_registry: HealthRegistry | None = None


def set_registry(reg: HealthRegistry | None) -> None:
    """Install the process-wide registry (node wiring).  Pipelines
    constructed without an explicit `health=` adopt it so every
    dispatch engine in the process shares one view of the chips."""
    global _registry
    _registry = reg


def registry() -> HealthRegistry | None:
    return _registry
