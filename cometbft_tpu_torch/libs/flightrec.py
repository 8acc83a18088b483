"""Flight recorder: a bounded ring buffer of structured events — the
port's copy of `cometbft_tpu.libs.flightrec`, with the event kinds the
verify plane records (verify flushes and their path, device fallbacks,
pipeline drains, quarantines, probes, watchdog timeouts, brownout, QoS
preemptions, SLO burns, verdict-cache lookups and insertions).

Recording is always on once a recorder is installed; the buffer is
bounded (old events are overwritten, the totals keep counting).  With
no recorder installed the hot paths pay one module-global read and an
`is None` test; with one, an event is a lock, two integer operations
and a list store.
"""

from __future__ import annotations

import logging
import time

from . import lockrank

_log = logging.getLogger(__name__)

DEFAULT_CAPACITY = 4096

# canonical event kinds (callers may record others; these are the ones
# the consensus/crypto layers emit)
EV_STEP = "step"                     # round-step transition
EV_NEW_HEIGHT = "new_height"         # height advanced (commit applied)
EV_TIMEOUT = "timeout"               # a scheduled timeout fired
EV_VOTE = "vote"                     # vote arrival (with lateness)
EV_PROPOSAL = "proposal"             # proposal receipt
EV_ESCALATION = "round_escalation"   # height moved past round 0
EV_VERIFY_FLUSH = "verify_flush"     # streaming-verifier flush
EV_DEVICE_FALLBACK = "device_fallback"  # device flush failed -> host
EV_RLC_FALLBACK = "rlc_fallback"     # RLC whole-batch check failed
EV_CACHE_LOOKUP = "cache_lookup"     # sigcache batch consult with hits
EV_CACHE_INSERT = "cache_insert"     # sigcache batch verdict insertion
EV_PIPELINE_DRAIN = "pipeline_drain"  # verify pipeline drained after a
#                                       mid-flight device failure
#                                       (crypto/dispatch.py); carries
#                                       inflight + staged depths
EV_DEVICE_HASH_FALLBACK = "device_hash_fallback"  # a window left the
#                                       fused device-hash path (message
#                                       exceeded the static SHA-512
#                                       block bucket) and re-staged
#                                       through host hashing
EV_STAGING_FALLBACK = "staging_fallback"  # a verify-pipeline window's
#                                       host staging raised (error,
#                                       detail = its type and repr) and
#                                       the window resolved on the host
EV_DEVICE_QUARANTINE = "device_quarantine"  # devhealth circuit breaker
#                                       opened: the device left the
#                                       dispatch rotation (fault rate,
#                                       hang, or a failed probe)
EV_DEVICE_PROBE = "device_probe"     # known-answer probe batch verdict
#                                       on a quarantined device (result
#                                       ok -> back in rotation, fail ->
#                                       backoff doubles)
EV_WATCHDOG_TIMEOUT = "watchdog_timeout"  # a device dispatch outlived
#                                       its deadline: window resolved
#                                       on the host, wedged thread
#                                       abandoned + replaced, device
#                                       quarantined
EV_BROWNOUT = "brownout"             # every device quarantined
#                                       (entered=True): pure host
#                                       fallback with bounded depth and
#                                       shrunken windows; entered=False
#                                       when a probe returns a chip
EV_LIGHTSERVE_REJECT = "lightserve_reject"  # the serving plane caught
#                                       an invalid commit signature in
#                                       a merged flush: that height's
#                                       requests fail, nothing is
#                                       served past it
EV_SLO_BURN = "slo_burn"             # latency-ledger SLO burn
#                                       (libs/latledger.py): a
#                                       consumer's short-window burn
#                                       rate tripped its declared p99
#                                       target budget; sustained=True
#                                       after consecutive trips (auto
#                                       dump-to-log)
EV_SCHED_PREEMPT = "sched_preempt"   # QoS scheduler (crypto/sched.py)
#                                       dispatched a higher-lane window
#                                       ahead of earlier-submitted
#                                       lower-lane ones; carries the
#                                       winning lane, its batch size,
#                                       and how many staged windows it
#                                       overtook (their wait books as
#                                       held time in SchedulerMetrics
#                                       and queue_wait in the ledger)


class FlightRecorder:
    """Bounded ring of (seq, monotonic, kind, fields) event tuples.

    `recorded` counts every event ever seen; the ring keeps the last
    `capacity` of them, so `dropped = recorded - len(ring)`.  Thread
    safe: consensus state thread, reactor gossip threads, and the
    votestream worker all record into one instance.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock=time.monotonic):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._clock = clock
        self._mtx = lockrank.RankedLock("flightrec.ring")
        self._ring: list = [None] * capacity
        self._recorded = 0

    # -- recording ---------------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        t = self._clock()
        with self._mtx:
            seq = self._recorded
            self._ring[seq % self.capacity] = (seq, t, kind, fields)
            self._recorded = seq + 1

    # -- reading -----------------------------------------------------------
    def __len__(self) -> int:
        with self._mtx:
            return min(self._recorded, self.capacity)

    @property
    def recorded(self) -> int:
        with self._mtx:
            return self._recorded

    def events(self) -> list[dict]:
        """Oldest-to-newest snapshot of the retained events."""
        with self._mtx:
            n = self._recorded
            kept = min(n, self.capacity)
            raw = [self._ring[(n - kept + i) % self.capacity]
                   for i in range(kept)]
        return [{"seq": seq, "t": t, "kind": kind, **dict(fields)}
                for (seq, t, kind, fields) in raw]

    def dump(self) -> dict:
        evs = self.events()
        return {
            "recorded": self.recorded,
            "dropped": self.recorded - len(evs),
            "capacity": self.capacity,
            "events": evs,
        }

    def summary(self) -> dict:
        """Per-kind counts over the retained window plus totals — the
        shape simnet reports per node next to its e2e rates."""
        counts: dict[str, int] = {}
        max_round = 0
        for e in self.events():
            counts[e["kind"]] = counts.get(e["kind"], 0) + 1
            if e["kind"] in (EV_STEP, EV_ESCALATION):
                max_round = max(max_round, int(e.get("round", 0)))
        return {"recorded": self.recorded,
                "dropped": self.recorded - len(self),
                "by_kind": counts,
                "max_round_seen": max_round}

    def dump_text(self) -> str:
        d = self.dump()
        lines = [f"flight recorder: {d['recorded']} recorded, "
                 f"{d['dropped']} dropped (capacity {d['capacity']})"]
        for e in d["events"]:
            extra = " ".join(f"{k}={v}" for k, v in e.items()
                             if k not in ("seq", "t", "kind"))
            lines.append(f"  #{e['seq']:<6} t={e['t']:.6f} "
                         f"{e['kind']:<16} {extra}")
        return "\n".join(lines)

    def dump_to_log(self, reason: str, logger=None) -> None:
        (logger or _log).warning("flight recorder dump (%s):\n%s",
                                 reason, self.dump_text())

    def clear(self) -> None:
        with self._mtx:
            self._ring = [None] * self.capacity
            self._recorded = 0


# -- process-wide seam -------------------------------------------------------
# Layers below any node wiring (crypto/votestream, crypto/batch) report
# through this, exactly like metrics.set_device_metrics / trace.set_tracer.
_recorder: FlightRecorder | None = None


def set_recorder(r: FlightRecorder | None) -> None:
    global _recorder
    _recorder = r


def recorder() -> FlightRecorder | None:
    return _recorder


def record(kind: str, **fields) -> None:
    """Record into the process-wide recorder; free when none is set."""
    r = _recorder
    if r is None:
        return
    r.record(kind, **fields)
