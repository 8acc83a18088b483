"""Prometheus-style metrics: the part of `cometbft_tpu.libs.metrics`
the verify plane reports through.

Counter / Gauge / Histogram with labels, a Registry and its text
exposition (Prometheus format 0.0.4), equal to the JAX package's for
the same series; the verify plane's bundles (DeviceMetrics,
CacheMetrics, DevprofMetrics, SchedulerMetrics) and their process-wide
seams.  The scrape server and the node's consensus / p2p / store
bundles come with the node.
"""

from __future__ import annotations

from . import lockrank




def _fmt_labels(names: tuple[str, ...], values: tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(
        '%s="%s"' % (n, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for n, v in zip(names, values))
    return "{%s}" % inner


class _Metric:
    def __init__(self, name: str, help_: str, label_names=()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._mtx = lockrank.RankedLock("metrics.series")
        self._values: dict[tuple[str, ...], float] = {}

    def labels(self, *values) -> "_Bound":
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected {len(self.label_names)} labels")
        return _Bound(self, tuple(str(v) for v in values))

    def _add(self, key: tuple[str, ...], delta: float) -> None:
        with self._mtx:
            self._values[key] = self._values.get(key, 0.0) + delta

    def _set(self, key: tuple[str, ...], value: float) -> None:
        with self._mtx:
            self._values[key] = value

    def collect(self) -> list[str]:
        with self._mtx:
            items = sorted(self._values.items())
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} {self.TYPE}"]
        if not items and not self.label_names:
            items = [((), 0.0)]
        for key, val in items:
            out.append(f"{self.name}{_fmt_labels(self.label_names, key)}"
                       f" {val:g}")
        return out


class _Bound:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric, key):
        self._metric = metric
        self._key = key

    def inc(self, delta: float = 1.0) -> None:
        self._metric._add(self._key, delta)

    def add(self, delta: float) -> None:
        self._metric._add(self._key, delta)

    def set(self, value: float) -> None:
        self._metric._set(self._key, value)

    def observe(self, value: float) -> None:
        self._metric._observe(self._key, value)


class Counter(_Metric):
    TYPE = "counter"

    def inc(self, delta: float = 1.0) -> None:
        self._add((), delta)

    def add(self, delta: float) -> None:
        self._add((), delta)


class Gauge(_Metric):
    TYPE = "gauge"

    def set(self, value: float) -> None:
        self._set((), value)

    def inc(self, delta: float = 1.0) -> None:
        self._add((), delta)

    def dec(self, delta: float = 1.0) -> None:
        self._add((), -delta)


DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10)


def _exp_buckets(start: float, factor: float, count: int):
    return tuple(start * factor ** i for i in range(count))



# The bucket layouts of duration histograms: same-quantity histograms
# stay mergeable across subsystems and processes; the latency ledger
# (libs/latledger.py) reuses "verify_latency".
BUCKET_SCHEMES: dict[str, tuple] = {
    "default": DEFAULT_BUCKETS,
    # sub-ms protocol stages up to ~26s (stage spans, step durations)
    "stage_fast": _exp_buckets(0.0001, 4, 10),
    # whole consensus rounds: 10ms up to ~76s
    "round": _exp_buckets(0.01, 2.7, 10),
    # kv store accesses: 0.2ms decades up to 2s
    "store_access": _exp_buckets(0.0002, 10, 5),
    # ABCI method timings (the reference's own layout)
    "abci_method": (.0001, .0004, .002, .009, .02, .1, .65, 2, 6, 25),
    # verify flushes: 0.5ms up to ~8s
    "flush": _exp_buckets(0.0005, 4, 8),
    # light-client serve latency: 1ms to 10s
    "serve": (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
              0.5, 1.0, 2.5, 5.0, 10.0),
    # per-request verify latency (libs/latledger.py): 0.2ms to ~3s
    # log-spaced — fine enough at the bottom for the vote path's p99,
    # wide enough at the top for brownout tails
    "verify_latency": _exp_buckets(0.0002, 2.5, 14),
}


class Histogram(_Metric):
    TYPE = "histogram"

    def __init__(self, name, help_, label_names=(),
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}

    def observe(self, value: float) -> None:
        self._observe((), value)

    def _observe(self, key: tuple[str, ...], value: float) -> None:
        with self._mtx:
            counts = self._counts.setdefault(
                key, [0] * (len(self.buckets) + 1))
            self._sums[key] = self._sums.get(key, 0.0) + value
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1

    def collect(self) -> list[str]:
        with self._mtx:
            items = sorted(self._counts.items())
            sums = dict(self._sums)
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        # exposition conformance: a label-less histogram with no
        # observations still emits its (zero) series, so scrapers never
        # see a # TYPE with no samples
        if not items and not self.label_names:
            items = [((), [0] * (len(self.buckets) + 1))]
        lnames = self.label_names + ("le",)
        for key, counts in items:
            cum = 0
            for i, ub in enumerate(self.buckets):
                cum += counts[i]
                # %g, not repr(): Prometheus renders le="1", never "1.0"
                out.append(f"{self.name}_bucket"
                           f"{_fmt_labels(lnames, key + ('%g' % ub,))} "
                           f"{cum}")
            cum += counts[-1]
            out.append(f"{self.name}_bucket"
                       f"{_fmt_labels(lnames, key + ('+Inf',))} {cum}")
            out.append(f"{self.name}_sum"
                       f"{_fmt_labels(self.label_names, key)} "
                       f"{sums.get(key, 0.0):g}")
            out.append(f"{self.name}_count"
                       f"{_fmt_labels(self.label_names, key)} {cum}")
        return out


class Registry:
    def __init__(self, namespace: str = "cometbft"):
        self.namespace = namespace
        self._mtx = lockrank.RankedLock("metrics.registry")
        self._metrics: list[_Metric] = []

    def _full(self, subsystem: str, name: str) -> str:
        return "_".join(p for p in (self.namespace, subsystem, name) if p)

    def counter(self, subsystem: str, name: str, help_: str,
                labels=()) -> Counter:
        m = Counter(self._full(subsystem, name), help_, labels)
        with self._mtx:
            self._metrics.append(m)
        return m

    def gauge(self, subsystem: str, name: str, help_: str,
              labels=()) -> Gauge:
        m = Gauge(self._full(subsystem, name), help_, labels)
        with self._mtx:
            self._metrics.append(m)
        return m

    def histogram(self, subsystem: str, name: str, help_: str,
                  labels=(), buckets=DEFAULT_BUCKETS) -> Histogram:
        m = Histogram(self._full(subsystem, name), help_, labels, buckets)
        with self._mtx:
            self._metrics.append(m)
        return m

    def expose(self) -> str:
        with self._mtx:
            metrics = list(self._metrics)
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.collect())
        return "\n".join(lines) + "\n"



# ---------------------------------------------------------------------------
# the verify plane's metric bundles
# ---------------------------------------------------------------------------

class TraceMetrics:
    """libs/trace.py stage spans: the per-stage wall-clock breakdown
    of the block ingest pipeline (decode -> verify-dispatch -> device
    -> apply -> store).  No reference analog — the reference profiles
    with pprof; here the host-residual around each device dispatch is
    the operational question."""

    def __init__(self, reg: Registry):
        self.stage_duration_seconds = reg.histogram(
            "trace", "stage_duration_seconds",
            "Wall-clock duration of one protocol stage span, by "
            "subsystem and stage.",
            labels=("subsystem", "stage"),
            buckets=BUCKET_SCHEMES["stage_fast"])
        self.intervals_dropped = reg.counter(
            "trace", "intervals_dropped_total",
            "Span interval records evicted from the StageTracer ring "
            "(overflow was previously silent).")



class DeviceMetrics:
    """The accelerator seam — the operational signal this framework
    exists for.  No reference analog: the reference's batch verifier is
    a CPU loop; here batch shape, flush cadence, and the RLC fast-path
    hit rate decide whether the TPU is earning its keep."""

    def __init__(self, reg: Registry):
        self.batch_size = reg.histogram(
            "device", "batch_size",
            "Signatures per verify flush, by execution path.",
            labels=("path",),
            buckets=(1, 8, 32, 128, 512, 2048, 8192, 32768))
        self.flush_latency_seconds = reg.histogram(
            "device", "flush_latency_seconds",
            "Wall-clock duration of one streaming-verifier flush, by "
            "resolution path (device / host / cache / drain).",
            labels=("path",),
            buckets=BUCKET_SCHEMES["flush"])
        self.flushes = reg.counter(
            "device", "flushes",
            "Streaming-verifier flushes, by execution path "
            "(device = batched TPU dispatch, host = CPU loop).",
            labels=("path",))
        self.rlc_fallbacks = reg.counter(
            "device", "rlc_fallbacks",
            "RLC whole-batch checks that failed and fell back to the "
            "per-signature verdict kernel.")
        self.device_hash_fallbacks = reg.counter(
            "device", "device_hash_fallbacks",
            "Pipeline windows that left the fused device-hash path "
            "(a message exceeded the static SHA-512 block bucket) and "
            "re-staged through host hashing.")
        self.a_table_cache_hits = reg.counter(
            "device", "a_table_cache_hits",
            "Device A-side table cache hits (validator set reused).")
        self.a_table_cache_misses = reg.counter(
            "device", "a_table_cache_misses",
            "Device A-side table cache misses (table built on device).")
        self.a_table_cache_bytes = reg.gauge(
            "device", "a_table_cache_bytes",
            "HBM bytes resident in the A-side table cache.")
        # secp256k1 MSM engine per-key window tables
        # (crypto/secp256k1.QTableCache — the same valset reuse
        # pattern as the A-side cache, Weierstrass flavor)
        self.q_table_cache_hits = reg.counter(
            "device", "q_table_cache_hits",
            "Device secp256k1 Q-table cache hits (key set reused).")
        self.q_table_cache_misses = reg.counter(
            "device", "q_table_cache_misses",
            "Device secp256k1 Q-table cache misses (tables built).")
        self.q_table_cache_bytes = reg.gauge(
            "device", "q_table_cache_bytes",
            "HBM bytes resident in the secp256k1 Q-table cache.")
        # the overlapped verify pipeline (crypto/dispatch.py): depth
        # gauges make the host/device overlap operationally visible
        self.pipeline_inflight = reg.gauge(
            "device", "pipeline_inflight_windows",
            "Verify-pipeline windows submitted and not yet resolved.")
        self.pipeline_staged = reg.gauge(
            "device", "pipeline_staging_depth",
            "Verify-pipeline windows host-packed and waiting on the "
            "device dispatch thread.")
        self.pipeline_drains = reg.counter(
            "device", "pipeline_drains",
            "Verify-pipeline drains: a mid-flight device failure made "
            "the faulted window and everything staged behind it "
            "resolve through the host fallback path.")
        # mesh round-robin dispatch (crypto/dispatch.py devices=...,
        # crypto/mesh.py split-RLC): per-device visibility so a limping
        # chip shows up as ITS series, not an aggregate wobble
        self.mesh_dispatches = reg.counter(
            "device", "mesh_dispatches",
            "Verify programs dispatched to a mesh device (round-robin "
            "pipeline windows and split-RLC chunks), by device index.",
            labels=("device",))
        self.pipeline_device_inflight = reg.gauge(
            "device", "pipeline_device_inflight_windows",
            "Verify-pipeline windows assigned to a mesh device and not "
            "yet resolved, by device index.",
            labels=("device",))
        self.pipeline_device_drains = reg.counter(
            "device", "pipeline_device_drains",
            "Per-device pipeline drains: a fault on one mesh device "
            "made windows assigned to it resolve through the host "
            "path (other devices keep dispatching), by device index.",
            labels=("device",))
        # device health circuit breaker (crypto/devhealth.py): the
        # availability contract with the accelerator — state per chip,
        # breaker trips, probe outcomes, and watchdog-caught hangs
        self.health_state = reg.gauge(
            "device", "health_state",
            "Device health state code (0=healthy 1=suspect "
            "2=quarantined 3=probing), by device index.",
            labels=("device",))
        self.quarantines = reg.counter(
            "device", "quarantines_total",
            "Circuit-breaker trips: a device left the dispatch "
            "rotation (fault rate over threshold, or a hang), by "
            "device index.",
            labels=("device",))
        self.probes = reg.counter(
            "device", "probes_total",
            "Known-answer probe batches dispatched to quarantined "
            "devices, by device index and result (ok returns the "
            "device to rotation; fail doubles its backoff).",
            labels=("device", "result"))
        self.watchdog_timeouts = reg.counter(
            "device", "watchdog_timeouts_total",
            "Dispatches the pipeline watchdog caught past the "
            "per-window deadline: window host-resolved, wedged thread "
            "abandoned and replaced, device quarantined, by device "
            "index.",
            labels=("device",))


class CacheMetrics:
    """The signature-verdict cache (crypto/sigcache.py): whether the
    process is re-proving facts it already knows.  The hits/misses
    split carries a `consumer` label (consensus / blocksync / light /
    evidence / validation / crypto) so the redundancy shows up per
    product path, not as one aggregate."""

    def __init__(self, reg: Registry):
        self.hits = reg.counter(
            "sigcache", "hits_total",
            "Signature-verdict cache hits (verdict served without "
            "re-verification), by consumer.", labels=("consumer",))
        self.negative_hits = reg.counter(
            "sigcache", "negative_hits_total",
            "Cache hits whose stored verdict is INVALID — a known-bad "
            "triple rejected without re-verification, by consumer.",
            labels=("consumer",))
        self.misses = reg.counter(
            "sigcache", "misses_total",
            "Signature-verdict cache misses (triple verified and "
            "inserted), by consumer.", labels=("consumer",))
        self.insertions = reg.counter(
            "sigcache", "insertions_total",
            "Verdicts inserted at a resolution seam, by consumer.",
            labels=("consumer",))
        self.evictions = reg.counter(
            "sigcache", "evictions_total",
            "LRU evictions (the bounded cache displaced its "
            "least-recently-used verdict).")
        self.entries = reg.gauge(
            "sigcache", "entries",
            "Verdicts currently resident in the cache.")
        self.votestream_coalesced = reg.counter(
            "sigcache", "votestream_coalesced_total",
            "Duplicate in-flight triples coalesced onto one "
            "StreamingVerifier batch slot (two peers flooding the "
            "same vote share one future).")


class P2PMetrics:
    """p2p/metrics.go: the peers gauge plus per-channel byte counters.
    The counters count framed wire bytes (length prefix + packet) at
    the MConnection seam, so both directions of a link agree."""

    def __init__(self, reg: Registry):
        self.peers = reg.gauge("p2p", "peers", "Number of peers.")
        self.message_send_bytes_total = reg.counter(
            "p2p", "message_send_bytes_total",
            "Wire bytes sent, by channel.", labels=("chID",))
        self.message_receive_bytes_total = reg.counter(
            "p2p", "message_receive_bytes_total",
            "Wire bytes received, by channel.", labels=("chID",))


class LightServeMetrics:
    """The coalescing light-client serving plane (lightserve/): how many
    sync requests one node is absorbing, how much verify work the
    coalescer merged away, and the serve-latency distribution (the
    fleet's light_serve_p99_ms).  Driven by LightServeSession and the
    request coalescer."""

    def __init__(self, reg: Registry):
        self.requests_total = reg.counter(
            "lightserve", "requests_total",
            "Light-client sync requests accepted (light_sync route "
            "or in-process session.sync).")
        self.coalesced_heights_total = reg.counter(
            "lightserve", "coalesced_heights_total",
            "Header-verify heights that attached to an already "
            "in-flight future instead of enqueueing their own verify "
            "(the cross-request dedupe).")
        self.headers_served_total = reg.counter(
            "lightserve", "headers_served_total",
            "Verified light blocks served to clients (one per path "
            "height per request).")
        self.verify_windows_total = reg.counter(
            "lightserve", "verify_windows_total",
            "Merged verify windows the serving plane flushed through "
            "the VerifyPipeline.")
        self.verify_sigs_total = reg.counter(
            "lightserve", "verify_sigs_total",
            "Commit signatures submitted for verification by the "
            "serving plane (after sigcache partition the pipeline "
            "dispatches the misses).")
        self.prefetched_headers_total = reg.counter(
            "lightserve", "prefetched_headers_total",
            "Light-block payloads the trust-path planner encoded "
            "ahead of demand into the serialized payload cache.")
        self.inflight_heights = reg.gauge(
            "lightserve", "inflight_heights",
            "Heights currently holding an unresolved shared verify "
            "future in the coalescer.")
        self.serve_seconds = reg.histogram(
            "lightserve", "serve_seconds",
            "Per-request serve latency (accept to last header "
            "handed back), seconds.",
            buckets=BUCKET_SCHEMES["serve"])


class DevprofMetrics:
    """The device-time accounting plane (libs/devprof.py): per-chip
    busy/idle partition (idle attributed by cause — staging /
    backpressure / no_work / drain), live occupancy.  Driven
    incrementally from DevprofRecorder.advance.  The JAX package's XLA
    compile-ledger series have no counterpart here yet."""

    def __init__(self, reg: Registry):
        self.busy_seconds = reg.counter(
            "devprof", "busy_seconds_total",
            "Seconds a verify-pipeline device spent dispatching "
            "windows, by device index.", labels=("device",))
        self.idle_seconds = reg.counter(
            "devprof", "idle_seconds_total",
            "Seconds a verify-pipeline device sat idle, by device "
            "index and attributed cause (staging / backpressure / "
            "no_work / drain).  busy + idle sums to the accounted "
            "wall-clock per device, exactly.",
            labels=("device", "cause"))
        self.occupancy = reg.gauge(
            "devprof", "occupancy_ratio",
            "Busy fraction of each device's accounted wall-clock "
            "(busy_seconds / wall), by device index.",
            labels=("device",))


class SchedulerMetrics:
    """The verify-plane QoS scheduler (crypto/sched.py): per-lane
    dispatch accounting on the shared VerifyPipeline.  Lanes are
    consumer labels from the closed registry (crypto/sigcache.LANES);
    preemptions count dispatches that overtook earlier-submitted
    lower-priority windows, held_seconds accumulates how long the
    overtaken windows waited (the same wait the latency ledger books
    as queue_wait), and lane_deficit exposes the deficit round-robin
    counters that keep equal-priority lanes fair."""

    def __init__(self, reg: Registry):
        self.dispatched_windows = reg.counter(
            "sched", "dispatched_windows",
            "Verify windows dispatched, by lane (consumer label).",
            labels=("lane",))
        self.dispatched_sigs = reg.counter(
            "sched", "dispatched_sigs",
            "Signatures dispatched, by lane.", labels=("lane",))
        self.preemptions = reg.counter(
            "sched", "preemptions_total",
            "Dispatches where this lane's window overtook at least "
            "one earlier-submitted lower-priority window.",
            labels=("lane",))
        self.held_seconds = reg.counter(
            "sched", "held_seconds_total",
            "Seconds windows of this lane spent overtaken (held "
            "staged while higher lanes dispatched ahead of them).",
            labels=("lane",))
        self.lane_deficit = reg.gauge(
            "sched", "lane_deficit_sigs",
            "Deficit round-robin balance, in signatures, by lane "
            "(equal-priority fairness state).", labels=("lane",))


# Process-wide device-metrics hook: the crypto layers (the pipeline,
# batch dispatch) sit below any node wiring, so they report through
# this seam when metrics are installed.
_device_metrics: DeviceMetrics | None = None


def set_device_metrics(dm: DeviceMetrics | None) -> None:
    global _device_metrics
    _device_metrics = dm


def device_metrics() -> DeviceMetrics | None:
    return _device_metrics


# Same seam for the signature-verdict cache (crypto/sigcache.py): the
# cache is process-wide and sits below node wiring.
_cache_metrics: CacheMetrics | None = None


def set_cache_metrics(cm: CacheMetrics | None) -> None:
    global _cache_metrics
    _cache_metrics = cm


def cache_metrics() -> CacheMetrics | None:
    return _cache_metrics


# ... and for the light-client serving plane (lightserve/): sessions
# are constructed lazily, below any node wiring.
_lightserve_metrics: LightServeMetrics | None = None


def set_lightserve_metrics(lm: LightServeMetrics | None) -> None:
    global _lightserve_metrics
    _lightserve_metrics = lm


def lightserve_metrics() -> LightServeMetrics | None:
    return _lightserve_metrics


# ... and for the device-time accounting plane (libs/devprof.py): the
# pipeline's dispatch threads drive it from below node wiring.
_devprof_metrics: DevprofMetrics | None = None


def set_devprof_metrics(dm: DevprofMetrics | None) -> None:
    global _devprof_metrics
    _devprof_metrics = dm


def devprof_metrics() -> DevprofMetrics | None:
    return _devprof_metrics


# ... and for the verify-plane QoS scheduler (crypto/sched.py): the
# pipeline's dispatch threads drive it from below node wiring.
_scheduler_metrics: SchedulerMetrics | None = None


def set_scheduler_metrics(sm: SchedulerMetrics | None) -> None:
    global _scheduler_metrics
    _scheduler_metrics = sm


def scheduler_metrics() -> SchedulerMetrics | None:
    return _scheduler_metrics
