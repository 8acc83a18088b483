"""Overlapped host/device verify pipeline: the port's copy of
`cometbft_tpu.crypto.dispatch`, the depth-K dispatch engine between the
product paths and the card.

- submit(items) returns at once with a WindowHandle future;
- a STAGING thread runs the host work (SHA-512 sign-bytes hashing in
  parse_and_hash, the signed-digit recode in pack_rlc) for window N+1
  while window N is on the device; hashlib releases the GIL, so a small
  pool hashes one window's chunks in parallel
  (parse_and_hash_parallel);
- a DEVICE thread dispatches the packed windows in QoS order
  (crypto/sched.py): priority lanes keyed by consumer label, deadline
  promotion, deficit round-robin between lanes of one class.  Verdicts
  resolve in per-lane submission order; with QoS off (qos=False)
  every window shares one lane and the queue is a global FIFO;
- depth-K backpressure: submit() blocks once K windows are unresolved.

The device thread launches the port's kernels: K1-K4 on an ed25519
window's RLC program, K1 + K14 on a reject's localization, K9 on the
device-hash route (COMETBFT_TPU_DEVICE_HASH=1) and K11-K13 through
MixedBatchVerifier for a mixed-key window.  The staging thread's
pack_rlc (Python and numpy), the host pool's parse_and_hash and the
device thread's launches and waits share one interpreter lock: how
much of the overlap survives is what libs/devprof.py's busy share and
idle causes read on the card.

Failure semantics are the serial path's: an RLC reject falls back to
the per-signature program (crypto/batch._device_verify does both), and
a DEVICE ERROR on an in-flight window drains the pipeline: that window
and everything staged behind it resolve on the host, signature by
signature.  The drain is recorded (flight recorder EV_PIPELINE_DRAIN /
EV_DEVICE_FALLBACK, DeviceMetrics pipeline gauges), never silent.  A
kernel that does not build or load (ops/_build.KernelBuildError) is no
device fault: it fails the window's handle and drains nothing, so a
broken install never runs its work on the host unseen.  A staging
exception routes its window to the host, as in the JAX package, and is
recorded (EV_STAGING_FALLBACK) and counted apart (staging_fallbacks)
from the windows that the size threshold sends there (host_windows).

The device: `device` (default "cuda") resolves through
ops/device.resolve when the pipeline is made, so without a card it
raises unless the caller passes device="cpu" (the kernels' plain
versions).  `devices=` is the mesh rotation, as in the JAX package
(COMETBFT_TPU_MESH_DEVICES through ops/sharding.mesh_device_list).

With no pipeline made nothing runs; trace spans land under the
submitter's subsystem (blocksync / light / consensus).
"""

from __future__ import annotations

import os
import threading
import time
from ..libs import lockrank
from concurrent.futures import Future, ThreadPoolExecutor

from ..libs.service import BaseService
from ..ops._build import KernelBuildError
from . import sched as qos_sched

# depth 2 = classic double buffering (pack N+1 while N is on device);
# deeper helps only when device time >> host time per window
DEFAULT_DEPTH = 2
# the host pool parallelizes WITHIN a window (parse_and_hash chunks);
# hashlib releases the GIL so this scales to real cores (the staging
# thread's pack_rlc and the device thread's launches hold it).  Sized from
# the machine (one core stays free for the device thread) instead of
# the old static min(4, cpu_count) cap, which left a 16-core host
# hashing on 4 threads; host_workers= pins it for one pipeline.
# Tests pass host_workers of 1-2: beside several test workers, a pool of
# cores - 1 threads per pipeline would only load the box.
DEFAULT_HOST_WORKERS = max(1, (os.cpu_count() or 2) - 1)
_MIN_PARALLEL_CHUNK = 256
# below this many signatures the hash runs INLINE on the staging
# thread: the pool handoff (submit + futures + result gather) costs
# more than hashlib saves on a tiny votestream flush
PARSE_INLINE_THRESHOLD = 2 * _MIN_PARALLEL_CHUNK
# hung-dispatch watchdog: a device call in flight past this deadline
# marks the device hung — the window (and everything staged behind it)
# resolves on the host, the wedged thread is abandoned + replaced, and
# the device quarantines (crypto/devhealth.py).  The default is
# deliberately generous: the kernels' first use builds them inside a
# dispatch thread (ops/_build.py, ~20 s with nvcc), and the plain
# versions on the CPU take seconds a window; a tripped watchdog on a
# merely-building card would quarantine every device at first use.
# dispatch_deadline_s=0 disables the watchdog.
DEFAULT_DISPATCH_DEADLINE_S = 600.0
# brownout shape: with EVERY device quarantined the pipeline degrades
# to pure host fallback — a tighter queue bound and a shrunken window
# cap (max_window(), consumed by blocksync's collector) keep the
# consensus hot path latency-bounded instead of livelocked
BROWNOUT_DEPTH = 2
BROWNOUT_MAX_WINDOW = 256
# deadline-aware QoS dispatch (crypto/sched.py): priority lanes,
# deficit round-robin, bounded device holds.  On by default; qos=False
# reverts one pipeline to the plain global-FIFO queue.
DEFAULT_QOS = True


def parse_and_hash_parallel(pubkeys, msgs, sigs, pool=None,
                            workers: int | None = None):
    """ed25519.parse_and_hash fanned across a thread pool in chunks.

    Byte-identical to the serial function: chunking only partitions
    the index space.
    Small batches (under PARSE_INLINE_THRESHOLD, or pool=None) stay
    serial — the fan-out overhead beats the hashing there.
    """
    from . import ed25519 as ed

    n = len(pubkeys)
    nworkers = workers if workers is not None else DEFAULT_HOST_WORKERS
    if pool is None or nworkers <= 1 or n < PARSE_INLINE_THRESHOLD:
        return ed.parse_and_hash(pubkeys, msgs, sigs)
    chunk = max(_MIN_PARALLEL_CHUNK, -(-n // nworkers))
    spans = [(i, min(i + chunk, n)) for i in range(0, n, chunk)]
    futs = [pool.submit(ed.parse_and_hash, pubkeys[a:b], msgs[a:b],
                        sigs[a:b]) for a, b in spans]
    out = []
    for f in futs:
        out.extend(f.result())
    return out


def _pk_bytes(pk) -> bytes:
    return pk.bytes() if hasattr(pk, "bytes") else bytes(pk)


def _key_type(pk) -> str:
    return pk.type() if hasattr(pk, "type") else "ed25519"


def _verify_one(pk, msg: bytes, sig: bytes) -> bool:
    """Host single-verify for any item shape the pipeline accepts
    (raw 32-byte ed25519 pubkeys or key objects); backend errors map
    to invalid, agreeing with crypto/batch.safe_verify."""
    from . import batch as cb

    if hasattr(pk, "verify_signature"):
        return cb.safe_verify(pk, msg, sig)
    from .votestream import _host_verify

    return _host_verify(_pk_bytes(pk), msg, sig)


def _device_scope(device):
    """The context a dispatch thread runs its loop in.  The current
    CUDA device (and with it the current stream that the kernel wrappers
    launch on, ops/device.stream) is per thread: a mesh dispatch thread
    for cuda:1, or a watchdog's replacement thread, must make its device
    current, or a launch may go to another device's stream than its
    data.  On one card every dispatch thread gets the default stream of
    cuda:0, which is right.  A CPU device needs no context."""
    import contextlib

    import torch

    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is None:
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _lat_stamp(handle: "WindowHandle", name: str) -> None:
    """Stamp a lifecycle cut on every latency-ledger request riding
    this window (libs/latledger.py); free when none are attached."""
    lat = handle.lat
    if lat:
        for req in lat:
            req.stamp(name)


class WindowHandle:
    """Future for one submitted window; resolves to (ok, verdicts)
    in submission order.  `path` records how the verdicts were
    produced once resolved: device / host / drain."""

    __slots__ = ("_future", "ctx", "subsystem", "path", "n",
                 "submitted_at", "resolved_at", "lat")

    def __init__(self, n: int, subsystem: str, ctx):
        # TrackedFuture is the sanitizer seam: a window future that
        # gets garbage-collected carrying an unretrieved exception is
        # a swallowed verify failure, and the leak fixture fails the
        # test that dropped it (libs/lockrank.py)
        self._future: Future = lockrank.TrackedFuture()
        self.ctx = ctx
        self.subsystem = subsystem
        self.path: str | None = None
        self.n = n
        self.submitted_at = time.monotonic()
        self.resolved_at: float | None = None
        # latency-ledger requests riding this window (None when the
        # ledger is off); committed — per request, with the window's
        # resolution path — the moment the future resolves, on
        # whichever thread resolved it
        self.lat: list | None = None

    def result(self, timeout: float | None = None):
        return self._future.result(timeout)

    def done(self) -> bool:
        return self._future.done()

    def add_done_callback(self, fn) -> None:
        self._future.add_done_callback(lambda _f: fn(self))

    # internal — idempotent: the watchdog may host-resolve a hung
    # window while its wedged dispatch thread is still inside the
    # device call; whichever lands second is a no-op, never an error
    def _resolve(self, ok: bool, verdicts: list, path: str) -> None:
        if self._future.done():
            return
        self.path = path
        self.resolved_at = time.monotonic()
        try:
            if self._future.set_running_or_notify_cancel():
                self._future.set_result((ok, list(verdicts)))
        except Exception:      # lost the watchdog race mid-set
            pass
        if self.lat:
            for req in self.lat:
                req.resolve(path)

    def _fail(self, exc: BaseException) -> None:
        if self._future.done():
            return
        self.resolved_at = time.monotonic()
        try:
            if self._future.set_running_or_notify_cancel():
                self._future.set_exception(exc)
        except Exception:      # lost the watchdog race mid-set
            pass
        if self.lat:
            for req in self.lat:
                req.resolve("error")


class _Window:
    __slots__ = ("items", "handle", "threshold", "mode", "pks",
                 "msgs", "parsed", "packed", "verifier", "staged",
                 "device_s", "device_index", "dispatching", "result",
                 "all_items", "cached", "dispatch_started",
                 "abandoned", "lane", "prio", "seq", "enqueued_at",
                 "held_since", "staging_active", "staging_error")

    def __init__(self, items, handle, threshold):
        # items = the MISSES after the verdict-cache partition (what
        # actually stages + dispatches); all_items/cached keep the
        # original window so verdicts merge back to one bool per
        # submitted item.  cached is None when nothing was partitioned.
        self.items = items
        self.handle = handle
        self.threshold = threshold
        self.all_items = items
        self.cached = None
        self.mode = None          # "ed" | "ed_hash" | "mixed" | "host"
        self.pks = None
        self.msgs = None          # kept for ed_hash reject localization
        self.parsed = None
        self.packed = None
        self.verifier = None
        self.staged = False
        self.device_s = 0.0
        # mesh round-robin state (devices=... pipelines): the assigned
        # device slot, whether its device thread picked it up, and the
        # computed (ok, verdicts, path) awaiting in-order publication
        self.device_index = 0
        self.dispatching = False
        self.result = None
        # watchdog state: when the dispatch call started, and whether
        # the watchdog host-resolved this window out from under a
        # wedged dispatch thread (the thread discards its result)
        self.dispatch_started = None
        self.abandoned = False
        # QoS scheduling state (crypto/sched.py), stamped by
        # QosScheduler.note_enqueue when the window enters the queue;
        # probe windows keep the defaults (they never enter _windows)
        self.lane = qos_sched.DEFAULT_LANE
        self.prio = 0
        self.seq = 0
        self.enqueued_at = 0.0
        self.held_since = None
        self.staging_active = False
        # the exception _stage raised, if any (the window then
        # resolves on the host, counted in staging_fallbacks)
        self.staging_error = None


class VerifyPipeline(BaseService):
    """Depth-K overlapped verify dispatch engine (module docstring)."""

    def __init__(self, depth: int = DEFAULT_DEPTH,
                 host_workers: int | None = None,
                 dispatch_fn=None, name: str = "VerifyPipeline",
                 devices=None, health=None,
                 dispatch_deadline_s: float | None = None,
                 qos: bool | None = None, device="cuda"):
        from ..ops import device as devmod

        super().__init__(name)
        # the card the single-device loop launches on (raises without
        # one unless device="cpu"); an un-indexed "cuda" is the JAX
        # package's device=None: the device current in the thread that
        # made the pipeline, and a mesh split where one is configured
        self.device = devmod.resolve(device)
        self._home = self.device
        if self.device.type == "cuda" and self.device.index is None:
            import torch

            self._home = torch.device("cuda", torch.cuda.current_device())
        # deadline-aware QoS dispatch order (crypto/sched.py); None
        # takes DEFAULT_QOS.  Off = one lane = exact FIFO.
        self.qos = DEFAULT_QOS if qos is None else bool(qos)
        self._sched = qos_sched.QosScheduler(enabled=self.qos)
        self.depth = max(1, depth)
        self.host_workers = (host_workers if host_workers is not None
                             else DEFAULT_HOST_WORKERS)
        # test/profiling seam: replaces the device-verify call; takes
        # the _Window, returns (ok, verdicts) or raises (exercising the
        # drain path exactly as a real device failure would)
        self._dispatch_fn = dispatch_fn
        # mesh round-robin: with >1 devices, windows are assigned
        # submission-index % n_devices, each device runs its own
        # dispatch thread, and verdicts still PUBLISH in submission
        # order (the blocksync/light ordering contract).  None defers
        # to the COMETBFT_TPU_MESH_DEVICES knob (off unless set); pass
        # an empty tuple to force single-device.  Callers should size
        # depth >= 2 * n_devices or the backpressure window starves
        # the rotation.
        if devices is None:
            try:
                from ..ops import sharding as _sharding

                devices = _sharding.mesh_device_list(None)
            except Exception:
                devices = None
        self.devices = list(devices) if devices is not None \
            and len(devices) > 1 else None
        # device health circuit breaker (crypto/devhealth.py): the
        # dispatch rotation skips quarantined devices, faults feed the
        # state machine, and recovery probes return chips to rotation.
        # None adopts the process registry (node wiring) or a private
        # one, so a bare VerifyPipeline() still has the full machinery.
        from . import devhealth as _devhealth

        self.health = health if health is not None else \
            (_devhealth.registry() or _devhealth.HealthRegistry())
        self.dispatch_deadline_s = (
            dispatch_deadline_s if dispatch_deadline_s is not None
            else DEFAULT_DISPATCH_DEADLINE_S)
        self._cv = lockrank.RankedCondition(name="dispatch.cv")
        self._windows: list[_Window] = []
        self._slots = threading.BoundedSemaphore(self.depth)
        self._pool: ThreadPoolExecutor | None = None
        self._staging: threading.Thread | None = None
        self._device: threading.Thread | None = None
        self._dev_threads: list[threading.Thread] = []
        self._stopping = False
        self._faulted = False      # draining after a device error
        self._dev_faulted: set[int] = set()   # per-device drain (mesh)
        # watchdog plumbing: per-device thread GENERATIONS (a wedged
        # dispatch thread is abandoned by bumping its device's gen and
        # spawning a replacement; the old thread sees the stale gen and
        # discards everything), in-flight probe registrations, the
        # health-aware round-robin cursor, and brownout latch
        self._gens: dict[str, int] = {}
        self._probe_inflight: dict[str, tuple[float, _Window]] = {}
        self._rr = 0
        self._brownout = False
        # brownout priority admission: waiting submitters by lane
        # priority class, so the tightened queue admits the most
        # urgent lane first and sheds the lowest lanes (under _cv)
        self._bo_waiters: dict[int, int] = {}
        self._watchdog: threading.Thread | None = None
        self._wd_wake = threading.Event()
        # per-object timeline override (libs/tracetl.py): lets a harness
        # attribute this pipeline's host_pack/device spans to one node's
        # timeline; None defers to the process seam
        self.timeline = None
        # stats (introspection)
        self.submitted = 0
        self.resolved = 0
        self.device_windows = 0
        self.host_windows = 0
        self.staging_fallbacks = 0
        self.drained_windows = 0
        self.faults = 0

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        self._stopping = False
        self._gens = {}
        self._probe_inflight = {}
        self._wd_wake = threading.Event()
        self._brownout = self.in_brownout()
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, self.host_workers),
            thread_name_prefix=f"{self._name}-host")
        self._staging = threading.Thread(
            target=self._staging_loop, name=f"{self._name}-staging",
            daemon=True)
        self._staging.start()
        if self.devices is not None:
            self._dev_threads = [
                threading.Thread(
                    target=self._run_dispatch_loop, args=(i, 0),
                    name=f"{self._name}-device-{i}", daemon=True)
                for i in range(len(self.devices))]
            for th in self._dev_threads:
                th.start()
        else:
            self._device = threading.Thread(
                target=self._run_dispatch_loop, args=(None, 0),
                name=f"{self._name}-device", daemon=True)
            self._device.start()
        if self.dispatch_deadline_s and self.dispatch_deadline_s > 0:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop,
                name=f"{self._name}-watchdog", daemon=True)
            self._watchdog.start()

    def on_stop(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self._wd_wake.set()
        for th in (self._staging, self._device, self._watchdog,
                   *self._dev_threads):
            if th is not None:
                th.join(timeout=5)
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        # a submit that raced stop() may have left windows behind the
        # exited threads: answer them on the host, free their slots
        with self._cv:
            leftovers, self._windows = list(self._windows), []
        for w in leftovers:
            t0 = time.monotonic()
            ok, verdicts = self._host_fallback(w)
            ok, verdicts = self._merge_cache(w, ok, verdicts)
            w.handle._resolve(ok, verdicts, "host")
            self._record_flush(w, "host", t0)
            try:
                self._slots.release()
            except ValueError:  # pragma: no cover
                pass

    def __enter__(self) -> "VerifyPipeline":
        if not self.is_running():
            self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- introspection -----------------------------------------------------

    @property
    def inflight(self) -> int:
        """Windows submitted and not yet resolved."""
        with self._cv:
            return len(self._windows)

    @property
    def staged(self) -> int:
        """Windows packed and waiting on the device thread."""
        with self._cv:
            return sum(1 for w in self._windows if w.staged)

    # -- device health / brownout ------------------------------------------

    def _device_keys(self) -> list[str]:
        if self.devices is not None:
            return [str(i) for i in range(len(self.devices))]
        return ["0"]

    def in_brownout(self) -> bool:
        """True when EVERY device this pipeline dispatches to is
        quarantined: verdicts still flow (pure host fallback) but the
        queue bound tightens to BROWNOUT_DEPTH and max_window() asks
        callers to shrink their windows."""
        return self.health.all_quarantined(self._device_keys())

    def max_window(self) -> int | None:
        """Advisory window-size cap for collectors; None = no cap."""
        return BROWNOUT_MAX_WINDOW if self._brownout else None

    def _check_brownout(self) -> None:
        """Re-derive the brownout latch from health state; record the
        edge transitions so the operator sees when the verify plane
        degraded to host-only and when a probe lifted it."""
        now_bo = self.in_brownout()
        with self._cv:
            was, self._brownout = self._brownout, now_bo
            if was != now_bo:
                self._cv.notify_all()
        if was != now_bo:
            from ..libs import flightrec

            flightrec.record(flightrec.EV_BROWNOUT, entered=now_bo,
                             depth=BROWNOUT_DEPTH,
                             max_window=BROWNOUT_MAX_WINDOW)
            rec = flightrec.recorder()
            if rec is not None and now_bo:
                rec.dump_to_log("verify-plane brownout: every device "
                                "quarantined, host-only fallback")

    def _pick_device_locked(self) -> int:
        """Health-aware round-robin over usable devices (called under
        self._cv at submit).  All quarantined -> plain rotation: the
        windows stage host-mode anyway and keep per-device queues
        drained."""
        if self.devices is None:
            return 0
        n = len(self.devices)
        usable = [i for i in range(n)
                  if self.health.usable(str(i))] or list(range(n))
        pick = usable[self._rr % len(usable)]
        self._rr += 1
        return pick

    def _gauge(self) -> None:
        from ..libs import devprof
        from ..libs import metrics as libmetrics

        dm = libmetrics.device_metrics()
        rec = devprof.recorder()
        if dm is None and rec is None:
            return
        with self._cv:
            n = len(self._windows)
            s = sum(1 for w in self._windows if w.staged)
            per_dev = None
            if self.devices is not None:
                per_dev = [0] * len(self.devices)
                for w in self._windows:
                    per_dev[w.device_index] += 1
        if dm is not None:
            dm.pipeline_inflight.set(n)
            dm.pipeline_staged.set(s)
            if per_dev is not None:
                for i, c in enumerate(per_dev):
                    dm.pipeline_device_inflight.labels(str(i)).set(c)
        if rec is not None:
            # Perfetto counter tracks: queue depth + per-device
            # in-flight windows under the occupancy tracks
            rec.counter("pipeline_queue_depth", n)
            rec.counter("pipeline_staged_windows", s)
            if per_dev is not None:
                for i, c in enumerate(per_dev):
                    rec.counter("inflight_windows/dev%d" % i, c)

    def _idle_cause(self, device_index: int | None = None) -> str:
        """Why a dispatch thread is about to wait — called under
        self._cv when a devprof recorder is installed.  drain: the
        pipeline (or this mesh device) is fault-draining; staging: a
        window exists for this device but its host work has not
        finished; no_work: the submit queue is empty (including
        cache-starved — fully-cached windows resolve at submit and
        never reach a device); backpressure: windows exist but none
        are dispatchable here (slots held by other devices' windows,
        or computed heads awaiting in-order publication);
        sched_hold: the QoS scheduler is deliberately keeping this
        chip idle — a strictly-higher-priority window is mid-staging
        and the bounded hold (sched.DEFAULT_HOLD_S) beats
        burning the device on lower-lane work."""
        from ..libs import devprof

        if self._sched.holding(device_index):
            return devprof.IDLE_SCHED_HOLD
        if device_index is None:
            if self._faulted:
                return devprof.IDLE_DRAIN
            if not self.health.usable("0"):
                return devprof.IDLE_QUARANTINE
            mine = self._windows
        else:
            if device_index in self._dev_faulted:
                return devprof.IDLE_DRAIN
            if not self.health.usable(str(device_index)):
                return devprof.IDLE_QUARANTINE
            mine = [w for w in self._windows
                    if w.device_index == device_index]
        if any(not w.staged for w in mine):
            return devprof.IDLE_STAGING
        if not self._windows:
            return devprof.IDLE_NO_WORK
        return devprof.IDLE_BACKPRESSURE

    # -- API ---------------------------------------------------------------

    def submit(self, items, *, subsystem: str = "pipeline", ctx=None,
               device_threshold: int | None = None,
               lat=None, lane: str | None = None) -> WindowHandle:
        """Queue one window of (pubkey, msg, sig) items; blocks when
        `depth` windows are already unresolved (backpressure).  The
        returned handle resolves — in per-lane submission order — to
        (ok, verdicts) with one bool per item.

        `lat` threads caller-created latency-ledger requests
        (libs/latledger.py) onto the window so a seam that already
        stamped its own queue wait (votestream, the light coalescer)
        is not double-counted; None (the default) opens one ledger
        request covering the whole window when a recorder is
        installed.

        `lane` overrides the QoS lane this window schedules under
        (crypto/sched.py) without changing `subsystem`, which keeps
        naming the trace/ledger/cache attribution — e.g. a blocksync
        window re-laned urgent still books its latency as blocksync.
        Must be a label registered in sigcache.LANES; anything else
        falls back to the subsystem's own lane."""
        if device_threshold is None:
            from . import batch as cb

            device_threshold = cb.DEVICE_THRESHOLD
        from . import sigcache

        items = list(items)
        handle = WindowHandle(len(items), subsystem, ctx)
        if lat is None and items:
            from ..libs import latledger

            req = latledger.submit(
                len(items),
                consumer=subsystem if subsystem in sigcache.CONSUMERS
                else None)
            lat = [req] if req is not None else None
        handle.lat = lat
        if not items:
            handle._resolve(False, [], "host")
            return handle
        # verdict-cache partition (crypto/sigcache.py): only misses
        # stage and dispatch; cached verdicts merge back at window
        # publication.  A fully-cached window resolves RIGHT HERE —
        # no slot, no staging, no device.
        cached = None
        misses = items
        if sigcache.enabled():
            verdicts, miss_idx = sigcache.partition(
                items, label=subsystem)
            if not miss_idx:
                full = [bool(v) for v in verdicts]
                handle._resolve(all(full), full, "cache")
                self._record_cache_window(handle, len(items))
                return handle
            if len(miss_idx) < len(items):
                cached = verdicts
                misses = [items[i] for i in miss_idx]
        if self._stopping or self._staging is None \
                or not self.is_running():
            # late submissions still answer, synchronously on the host
            # (the votestream submit-after-stop contract)
            verdicts = [_verify_one(pk, m, s) for pk, m, s in items]
            handle._resolve(all(verdicts), verdicts, "host")
            return handle
        label = self._sched.lane_for(subsystem, lane)
        prio = self._sched.priority(label)
        self._slots.acquire()
        win = _Window(misses, handle, device_threshold)
        win.all_items = items
        win.cached = cached
        with self._cv:
            # brownout: beyond the depth-K slot bound, hold submitters
            # to a tighter queue so host-only verify latency stays
            # bounded instead of piling K windows of backlog.  The
            # admission is priority-aware: while a strictly more
            # urgent lane is also waiting, this submitter yields its
            # queue spot — the degraded capacity sheds the lowest
            # lanes first.
            self._bo_waiters[prio] = self._bo_waiters.get(prio, 0) + 1
            try:
                while not self._stopping and self._brownout \
                        and (len(self._windows) >= BROWNOUT_DEPTH
                             or any(c and p < prio for p, c
                                    in self._bo_waiters.items())):
                    self._cv.wait(timeout=0.05)
            finally:
                self._bo_waiters[prio] -= 1
                if not self._bo_waiters[prio]:
                    del self._bo_waiters[prio]
            win.device_index = self._pick_device_locked()
            self._sched.note_enqueue(win, label)
            self._windows.append(win)
            self.submitted += 1
            self._cv.notify_all()
        self._gauge()
        return handle

    def qos_seal_due(self, consumer: str) -> bool:
        """Window-formation advisory for accumulators (votestream, the
        light coalescer): True when sealing the in-formation window
        NOW beats batching further — the queue holds work from a
        *different* priority class (a higher lane queued means this
        bulk window should be cut short so it clears fast; a lower
        lane queued means this urgent window should seal and jump
        it).  False with QoS off, on an empty queue (the accumulator's
        flush interval is the designed latency), and under pure
        own-class backpressure — there batching up stays the
        efficient move."""
        if not self.qos or not self.is_running():
            return False
        # lock-free peek: accumulators poll this at millisecond
        # cadence while a batch forms, and the common case is an
        # empty queue — a stale read only delays/advances an advisory
        # by one poll tick, so don't tax the dispatch cv for it
        if not self._windows:
            return False
        with self._cv:
            return self._sched.seal_due(self._windows, consumer,
                                        time.monotonic())

    def scheduler_snapshot(self) -> dict:
        """Per-lane dispatch counters."""
        with self._cv:
            return self._sched.snapshot()

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every submitted window has resolved."""
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        with self._cv:
            while self._windows:
                left = None if deadline is None else \
                    deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cv.wait(timeout=left if left is not None else 0.1)
        return True

    # -- staging (host pack) -----------------------------------------------

    def _next_unstaged(self) -> _Window | None:
        # QoS order: most urgent effective class first, FIFO within it
        # (with QoS off this is exactly the old first-unstaged scan)
        return self._sched.next_unstaged(self._windows,
                                         time.monotonic())

    def _staging_loop(self) -> None:
        from ..libs import trace as libtrace
        from ..libs import tracetl
        from . import ed25519 as ed

        while True:
            with self._cv:
                while self._next_unstaged() is None \
                        and not self._stopping:
                    self._cv.wait(timeout=0.1)
                if self._stopping and self._next_unstaged() is None:
                    return
                win = self._next_unstaged()
                # visible to pick_dispatch: a free device may briefly
                # hold for this window if it outranks the staged work
                win.staging_active = True
            # span name decided UP FRONT from the knob (not win.mode,
            # set inside _stage): in device-hash mode the staging
            # thread's job shrinks to splice+pack, and the split
            # host_splice/device_hash names keep tracetl's critical
            # path decomposition summing exactly (both map into the
            # existing host_pack/device segments)
            stage_span = "host_splice" if (
                ed.device_hash_enabled()
                and os.environ.get("COMETBFT_TPU_PROVIDER",
                                   "auto") != "cpu") else "host_pack"
            _lat_stamp(win.handle, "stage_start")
            try:
                with libtrace.span(win.handle.subsystem, stage_span,
                                   inflight=len(self._windows)), \
                        tracetl.span_for(
                            self, win.handle.subsystem, stage_span,
                            **tracetl.ctx_fields(win.handle.ctx)):
                    self._stage(win)
            except Exception as e:
                # a staging failure must not wedge the queue: route the
                # window to the host path for verdicts, and say so
                win.staging_error = e
                win.mode = "host"
                self._record_staging_fallback(win, e)
            _lat_stamp(win.handle, "stage_end")
            with self._cv:
                win.staging_active = False
                win.staged = True
                self._cv.notify_all()
            self._gauge()

    def _stage(self, win: _Window) -> None:
        """Host work for one window: key-type split, parallel SHA-512
        parse+hash, RLC packing (signed-digit recode) — everything the
        device dispatch needs, done while the PREVIOUS window is on
        device."""
        items = win.items
        if self._brownout:
            # every device quarantined: skip the device staging work
            # entirely, the window can only resolve on the host
            win.mode = "host"
            return
        provider = os.environ.get("COMETBFT_TPU_PROVIDER", "auto")
        all_ed = all(_key_type(pk) == "ed25519" for pk, _, _ in items)
        if provider == "cpu" or len(items) < max(1, win.threshold):
            win.mode = "host"
            return
        if not all_ed:
            # mixed key types: batch.MixedBatchVerifier handles the
            # per-type split (its sub-batches dispatch concurrently);
            # the device thread runs verify() so ordering holds
            from . import batch as cb

            bv = cb.MixedBatchVerifier(device=self._window_device(win))
            for pk, m, s in items:
                bv.add(pk, m, s)
            win.mode = "mixed"
            win.verifier = bv
            return
        from . import ed25519 as ed

        pks = [_pk_bytes(pk) for pk, _, _ in items]
        msgs = [m for _, m, _ in items]
        sigs = [s for _, _, s in items]
        win.pks = pks
        n = len(pks)
        if ed.device_hash_enabled() and n >= 2:
            # fused hash-to-scalar staging: structural parse + splice
            # only — hashing, zh aggregation and the A-side recode run
            # on device.  Structural rejects and oversized messages
            # fall through to the host-hash staging below (the drain
            # path is unchanged; the fallback is observable).
            parsed = ed.parse_batch(pks, sigs)
            if all(p is not None for p in parsed):
                try:
                    win.packed = ed.pack_rlc_device_hash(
                        pks, msgs, sigs, parsed=parsed)
                    win.parsed = parsed
                    win.msgs = msgs
                    win.mode = "ed_hash"
                    return
                except ValueError:
                    self._record_hash_fallback(n)
        win.parsed = parse_and_hash_parallel(
            pks, msgs, sigs, pool=self._pool,
            workers=self.host_workers)
        if n >= 2:
            # pack (aggregation + recode) here so the device thread
            # only dispatches; None = structural reject, the device
            # stage localizes with the per-signature kernel
            win.packed = ed.pack_rlc(pks, [b""] * n, [b""] * n,
                                     parsed=win.parsed)
        win.mode = "ed"

    def _record_staging_fallback(self, win: _Window,
                                 exc: Exception) -> None:
        from ..libs import flightrec
        from ..libs import tracetl

        flightrec.record(flightrec.EV_STAGING_FALLBACK,
                         batch=len(win.items),
                         subsystem=win.handle.subsystem,
                         error=type(exc).__name__, detail=repr(exc),
                         **tracetl.ctx_fields(win.handle.ctx))

    def _record_hash_fallback(self, n: int) -> None:
        """A window left the device-hash path (message exceeded the
        static SHA-512 block bucket): count it and leave a flightrec
        breadcrumb — the window still verifies via host-hash staging."""
        from ..libs import flightrec
        from ..libs import metrics as libmetrics

        dm = libmetrics.device_metrics()
        if dm is not None:
            dm.device_hash_fallbacks.inc()
        flightrec.record(flightrec.EV_DEVICE_HASH_FALLBACK, batch=n)

    # -- device (ordered dispatch) -------------------------------------

    def _window_device(self, win: _Window):
        """The device a window dispatches to: its mesh slot's, or the
        pipeline's own."""
        if self.devices is None:
            return self.device
        from ..ops import device as devmod

        return devmod.resolve(self.devices[win.device_index])

    def _run_dispatch_loop(self, idx: int | None, gen: int) -> None:
        """A dispatch thread's body: its device loop under its device's
        context (_device_scope), the single-device loop when idx is
        None."""
        if idx is None:
            with _device_scope(self._home):
                self._device_loop(gen)
        else:
            with _device_scope(self.devices[idx]):
                self._mesh_device_loop(idx, gen)

    def _device_loop(self, gen: int = 0) -> None:
        from ..libs import devprof

        dev = "0"
        while True:
            # devprof accounting (libs/devprof.py): classify WHY this
            # thread is about to wait (under the lock, where the queue
            # state is coherent), then attribute the waited gap to that
            # cause on wake — so busy + attributed idle partition the
            # device's wall-clock exactly
            rec = devprof.recorder()
            cause = devprof.IDLE_NO_WORK
            probe = False
            ev = None
            with self._cv:
                while True:
                    if gen != self._gens.get(dev, 0):
                        # the watchdog abandoned this thread (hung
                        # dispatch) and a replacement owns the queue
                        return
                    if self._probe_due_locked(dev):
                        probe = True
                        break
                    win, holding = self._sched.pick_dispatch(
                        self._windows, None, time.monotonic())
                    if win is not None:
                        win.dispatching = True
                        win.dispatch_started = time.monotonic()
                        _lat_stamp(win.handle, "dispatch")
                        ev = self._sched.note_dispatch(
                            win, self._windows, win.dispatch_started)
                        break
                    if self._stopping and not self._windows:
                        return
                    if rec is not None:
                        cause = self._idle_cause()
                    # stopping with an unstaged head: the staging loop
                    # drains every submitted window before exiting.  A
                    # QoS hold wakes on its own (short) budget so the
                    # held device re-evaluates promptly.
                    self._cv.wait(timeout=max(0.001, self._sched.hold_s)
                                  if holding else 0.05)
                    if rec is not None:
                        rec.advance(dev, cause)
            if rec is not None:
                # close the residual gap (lock wakeup to dispatch
                # start) under the last known cause
                rec.advance(dev, cause)
            if probe:
                self._run_probe(dev, None, gen)
                continue
            self._sched.emit(ev)
            self._resolve_window(win)
            with self._cv:
                stale = gen != self._gens.get(dev, 0) or win.abandoned
            if stale:
                # the watchdog host-resolved this window (and did the
                # pop/release bookkeeping) while we were wedged in the
                # device call; everything downstream is not ours
                return
            if rec is not None:
                path = win.handle.path
                if path in ("device", "host"):
                    rec.advance(dev, devprof.BUSY, path=path)
                else:                     # drain (or a failed resolve)
                    rec.advance(dev, devprof.IDLE_DRAIN)
            with self._cv:
                # under QoS the resolved window need not be the head
                # (it may have overtaken earlier lower-lane windows):
                # remove by identity
                try:
                    self._windows.remove(win)
                except ValueError:  # watchdog already popped it
                    pass
                if not self._windows:
                    # queue empty: a drain ends here, device dispatch
                    # resumes for subsequent submissions
                    self._faulted = False
                self.resolved += 1
                self._cv.notify_all()
            self._slots.release()
            self._gauge()

    def _compute_verdicts(self, win: _Window, faulted: bool,
                          device=None, device_index=None,
                          quarantined: bool = False):
        """The path decision + verdict computation shared by the
        single-device loop and the per-device mesh loops; returns
        (ok, verdicts, path).  A KernelBuildError from the dispatch
        raises: the caller fails the window's handle with it."""
        if faulted and win.mode in ("ed", "ed_hash", "mixed"):
            # draining after a device fault: everything staged
            # behind the faulted window resolves on the host
            ok, verdicts = self._host_fallback(win)
            self.drained_windows += 1
            return ok, verdicts, "drain"
        if win.mode == "host":
            ok, verdicts = self._host_fallback(win)
            if win.staging_error is not None:
                self.staging_fallbacks += 1
            else:
                self.host_windows += 1
            return ok, verdicts, "host"
        if quarantined:
            # circuit breaker open: the staged work is not trusted to
            # this device — host path, NOT a drain (the pipeline is
            # healthy, only this chip is benched awaiting a probe)
            ok, verdicts = self._host_fallback(win)
            self.host_windows += 1
            return ok, verdicts, "host"
        try:
            ok, verdicts = self._device_dispatch(win, device=device)
            if win.abandoned:
                return ok, verdicts, "device"
            self.device_windows += 1
            self.health.note_ok(str(device_index)
                                if device_index is not None else "0")
            return ok, verdicts, "device"
        except KernelBuildError:
            # not a device fault (first use builds inside this thread,
            # ops/_build.py): draining to the host would hide a broken
            # install behind correct verdicts
            raise
        except Exception as e:
            if win.abandoned:
                # a wedged device call erupting AFTER the watchdog
                # already handled this window: the hang was counted
                # (note_hang, quarantine) when the thread was
                # abandoned — feeding this stale error to the health
                # machine would re-quarantine a chip that may have
                # since probed back to healthy
                return False, [False] * len(win.items), "error"
            # device trouble mid-pipeline: drain.  The host
            # path is still correct; the operator must see
            # the fault and the drain in the timeline.  A sticky CUDA
            # error (an illegal address) poisons the process's context:
            # every later dispatch and probe faults here too, the
            # device quarantines and the pipeline enters brownout.
            self._fault(e, win, device_index=device_index)
            ok, verdicts = self._host_fallback(win)
            self.drained_windows += 1
            return ok, verdicts, "drain"

    def _merge_cache(self, win: _Window, ok: bool, verdicts: list):
        """Window publication: insert every COMPUTED verdict into the
        verdict cache (this is a resolution seam — even verdicts whose
        consumer cancel-raced the window become future hits), then
        merge with the cached slots back to one bool per submitted
        item."""
        from . import sigcache

        if win.items:
            sigcache.insert_many(win.items, verdicts,
                                 label=win.handle.subsystem)
        if win.cached is None:
            return ok, verdicts
        merged = list(win.cached)
        it = iter(verdicts)
        for i, v in enumerate(merged):
            if v is None:
                merged[i] = bool(next(it))
            else:
                merged[i] = bool(v)
        return all(merged) and bool(merged), merged

    def _cache_hits(self, win: _Window) -> int:
        return len(win.all_items) - len(win.items)

    def _record_cache_window(self, handle: WindowHandle,
                             n: int) -> None:
        """A fully-cached window resolved at submit: record it like a
        flush so the path mix (device/host/cache) reads in one series."""
        from ..libs import flightrec
        from ..libs import metrics as libmetrics
        from ..libs import tracetl

        dm = libmetrics.device_metrics()
        if dm is not None:
            dm.flushes.labels("cache").inc()
            dm.batch_size.labels("cache").observe(n)
            if handle.resolved_at is not None:
                dm.flush_latency_seconds.labels("cache").observe(
                    handle.resolved_at - handle.submitted_at)
        flightrec.record(
            flightrec.EV_VERIFY_FLUSH, path="cache", batch=n,
            cache_hits=n, subsystem=handle.subsystem,
            inflight=len(self._windows), staged=self.staged,
            **tracetl.ctx_fields(handle.ctx))

    def _record_flush(self, win: _Window, path: str, t0: float) -> None:
        from ..libs import flightrec
        from ..libs import metrics as libmetrics
        from ..libs import tracetl

        dm = libmetrics.device_metrics()
        if dm is not None:
            dm.flushes.labels(path).inc()
            dm.batch_size.labels(path).observe(len(win.items))
            dm.flush_latency_seconds.labels(path).observe(
                time.monotonic() - t0)
            if self.devices is not None and path == "device":
                dm.mesh_dispatches.labels(
                    str(win.device_index)).inc()
        flightrec.record(
            flightrec.EV_VERIFY_FLUSH, path=path,
            batch=len(win.items),
            cache_hits=self._cache_hits(win),
            subsystem=win.handle.subsystem,
            inflight=len(self._windows), staged=self.staged,
            **tracetl.ctx_fields(win.handle.ctx))

    def _resolve_window(self, win: _Window) -> None:
        from ..libs import trace as libtrace
        from ..libs import tracetl

        t0 = time.monotonic()
        path = "host"
        dev_span = "device_hash" if win.mode == "ed_hash" else "device"
        try:
            with libtrace.span(win.handle.subsystem, dev_span,
                               inflight=len(self._windows)), \
                    tracetl.span_for(
                        self, win.handle.subsystem, dev_span,
                        cache=self._cache_hits(win),
                        **tracetl.ctx_fields(win.handle.ctx)):
                ok, verdicts, path = self._compute_verdicts(
                    win, self._faulted,
                    quarantined=not self.health.usable("0"))
            if win.abandoned:
                # the watchdog already host-resolved this window
                return
            win.device_s = time.monotonic() - t0
            _lat_stamp(win.handle, "compute_end")
            ok, verdicts = self._merge_cache(win, ok, verdicts)
            win.handle._resolve(ok, verdicts, path)
        except BaseException as e:  # a KernelBuildError, or a defect
            if win.abandoned:
                return
            win.handle._fail(e)
            path = "error"
        finally:
            if not win.abandoned:
                self._record_flush(win, path, t0)

    # -- mesh round-robin (one dispatch thread per device) ---------------

    def _mesh_device_loop(self, idx: int, gen: int = 0) -> None:
        from ..libs import devprof
        from ..libs import trace as libtrace
        from ..libs import tracetl

        dev = str(idx)
        while True:
            # same devprof gap-attribution discipline as _device_loop,
            # per mesh device: classify the wait under the lock,
            # attribute the gap on wake
            rec = devprof.recorder()
            cause = devprof.IDLE_NO_WORK
            probe = False
            ev = None
            with self._cv:
                while True:
                    if gen != self._gens.get(dev, 0):
                        # abandoned by the watchdog; the replacement
                        # thread owns this device's queue now
                        return
                    if self._probe_due_locked(dev):
                        probe = True
                        break
                    win, holding = self._sched.pick_dispatch(
                        self._windows, idx, time.monotonic())
                    if win is not None:
                        win.dispatching = True
                        win.dispatch_started = time.monotonic()
                        _lat_stamp(win.handle, "dispatch")
                        ev = self._sched.note_dispatch(
                            win, self._windows, win.dispatch_started)
                        break
                    if self._stopping and not any(
                            w.device_index == idx and w.result is None
                            for w in self._windows):
                        return
                    if rec is not None:
                        cause = self._idle_cause(device_index=idx)
                    self._cv.wait(timeout=max(0.001, self._sched.hold_s)
                                  if holding else 0.05)
                    if rec is not None:
                        rec.advance(dev, cause)
                faulted = idx in self._dev_faulted
                quarantined = not self.health.usable(dev)
            if rec is not None:
                rec.advance(dev, cause)
            if probe:
                self._run_probe(dev, self.devices[idx], gen)
                continue
            self._sched.emit(ev)
            t0 = time.monotonic()
            path = "host"
            dev_span = "device_hash" if win.mode == "ed_hash" \
                else "device"
            try:
                with libtrace.span(win.handle.subsystem, dev_span,
                                   inflight=len(self._windows),
                                   device=idx), \
                        tracetl.span_for(
                            self, win.handle.subsystem, dev_span,
                            device=idx, cache=self._cache_hits(win),
                            **tracetl.ctx_fields(win.handle.ctx)):
                    ok, verdicts, path = self._compute_verdicts(
                        win, faulted, device=self.devices[idx],
                        device_index=idx, quarantined=quarantined)
                win.device_s = time.monotonic() - t0
                _lat_stamp(win.handle, "compute_end")
                ok, verdicts = self._merge_cache(win, ok, verdicts)
                with self._cv:
                    if gen != self._gens.get(dev, 0) or win.abandoned:
                        # the watchdog resolved this window while we
                        # were wedged; discard everything
                        return
                    win.result = (ok, verdicts, path)
            except BaseException as e:  # a KernelBuildError, or a defect
                with self._cv:
                    if gen != self._gens.get(dev, 0) or win.abandoned:
                        return
                    win.result = (None, e, "error")
                path = "error"
            if rec is not None:
                if path in ("device", "host"):
                    rec.advance(dev, devprof.BUSY, path=path)
                else:
                    rec.advance(dev, devprof.IDLE_DRAIN)
            self._record_flush(win, path, t0)
            self._publish_resolved(idx)

    def _publish_resolved(self, idx: int) -> None:
        """Pop and resolve every computed window that is the head of
        its LANE — verdicts publish in per-lane submission order no
        matter which device finished first.  With QoS off every
        window shares one lane, making this exactly the old
        global-head publication."""
        done: list[_Window] = []
        with self._cv:
            blocked: set = set()
            i = 0
            while i < len(self._windows):
                w = self._windows[i]
                if w.result is not None and w.lane not in blocked:
                    done.append(self._windows.pop(i))
                    self.resolved += 1
                    continue
                blocked.add(w.lane)
                i += 1
            if idx in self._dev_faulted and not any(
                    w.device_index == idx for w in self._windows):
                # this device's queue drained: device dispatch resumes
                # for its subsequent windows
                self._dev_faulted.discard(idx)
            if done:
                self._cv.notify_all()
        for w in done:
            ok, verdicts, path = w.result
            if path == "error":
                w.handle._fail(verdicts)
            else:
                w.handle._resolve(ok, verdicts, path)
            self._slots.release()
        if done:
            self._gauge()

    def _device_dispatch(self, win: _Window, device=None):
        if self._dispatch_fn is not None:
            return self._dispatch_fn(win)
        if win.mode == "mixed":
            return win.verifier.verify()
        from ..ops import device as devmod
        from . import batch as cb

        device = self.device if device is None else devmod.resolve(device)
        if win.mode == "ed_hash":
            return cb._device_verify_hash(win.pks, win.msgs,
                                          win.parsed,
                                          packed=win.packed,
                                          device=device)
        return cb._device_verify(win.pks, win.parsed, device,
                                 packed=win.packed)

    def _host_fallback(self, win: _Window):
        verdicts = [_verify_one(pk, m, s) for pk, m, s in win.items]
        return all(verdicts) and bool(verdicts), verdicts

    def _fault(self, exc: Exception, win: _Window,
               device_index: int | None = None) -> None:
        from ..libs import flightrec
        from ..libs import metrics as libmetrics
        from ..libs import tracetl

        with self._cv:
            if device_index is None:
                self._faulted = True
            else:
                # mesh mode: only THIS device drains — windows
                # round-robined onto the other devices keep
                # dispatching (per-device fault isolation)
                self._dev_faulted.add(device_index)
            self.faults += 1
            staged_behind = sum(1 for w in self._windows if w.staged)
        dm = libmetrics.device_metrics()
        if dm is not None:
            dm.pipeline_drains.inc()
            if device_index is not None:
                dm.pipeline_device_drains.labels(
                    str(device_index)).inc()
        rec = flightrec.recorder()
        ctxf = tracetl.ctx_fields(win.handle.ctx)
        flightrec.record(flightrec.EV_DEVICE_FALLBACK,
                         batch=len(win.items),
                         error=type(exc).__name__, **ctxf)
        flightrec.record(flightrec.EV_PIPELINE_DRAIN,
                         batch=len(win.items),
                         inflight=len(self._windows),
                         staged=staged_behind,
                         device=device_index,
                         error=type(exc).__name__, **ctxf)
        if rec is not None:
            rec.dump_to_log(
                "pipeline device dispatch failed, draining: %r" % exc)
        # feed the health state machine: repeated faults inside the
        # window trip the quarantine circuit breaker and pull this
        # device out of the dispatch rotation
        self.health.note_fault(
            str(device_index) if device_index is not None else "0",
            reason=type(exc).__name__)
        self._check_brownout()

    # -- hung-dispatch watchdog ------------------------------------------

    def _watchdog_loop(self) -> None:
        """Deadline enforcement for in-flight device work: a dispatch
        (or probe) that outlives dispatch_deadline_s is resolved on the
        host, its wedged thread abandoned + replaced, and its device
        quarantined as hung.  The futures contract survives a wedge:
        no window is ever left unresolved."""
        deadline = self.dispatch_deadline_s
        interval = max(0.02, min(1.0, deadline / 4.0))
        while not self._stopping:
            self._wd_wake.wait(timeout=interval)
            if self._stopping:
                return
            self._scan_hung()

    def _scan_hung(self) -> None:
        deadline = self.dispatch_deadline_s
        now = time.monotonic()
        hung = None
        hung_probe = None
        with self._cv:
            for w in self._windows:
                if w.dispatching and not w.abandoned \
                        and w.result is None \
                        and not w.handle.done() \
                        and w.dispatch_started is not None \
                        and now - w.dispatch_started > deadline:
                    hung = w
                    break
            if hung is None:
                for d, (t0, _w) in self._probe_inflight.items():
                    if now - t0 > deadline:
                        hung_probe = d
                        break
        if hung is not None:
            self._handle_hang(hung, now)
        elif hung_probe is not None:
            self._handle_probe_hang(hung_probe, now)

    def _handle_hang(self, win: _Window, now: float) -> None:
        idx = win.device_index if self.devices is not None else None
        dev = str(idx) if idx is not None else "0"
        with self._cv:
            # re-check under the lock: the wedged thread may have
            # finished between the scan and here
            if win.abandoned or win.result is not None \
                    or win.handle.done() \
                    or win not in self._windows:
                return
            win.abandoned = True
            waited = now - (win.dispatch_started or now)
            self.faults += 1
            if idx is None:
                self._faulted = True
            else:
                self._dev_faulted.add(idx)
            # abandon the wedged thread: bump its generation (it will
            # discard its result and exit when the device call ever
            # returns) and hand the queue to a fresh replacement
            gen = self._gens.get(dev, 0) + 1
            self._gens[dev] = gen
            staged_behind = sum(1 for w in self._windows if w.staged)
            self._cv.notify_all()
        self._spawn_dispatch_thread(idx, gen)
        self.health.note_hang(dev)
        self._check_brownout()
        self._record_watchdog(dev, win, waited, staged_behind)
        # answer the hung window on the host so its future resolves —
        # the consumer contract survives the wedge
        ok, verdicts = self._host_fallback(win)
        ok, verdicts = self._merge_cache(win, ok, verdicts)
        self.drained_windows += 1
        if self.devices is None:
            win.handle._resolve(ok, verdicts, "drain")
            with self._cv:
                if self._windows and self._windows[0] is win:
                    self._windows.pop(0)
                else:
                    # QoS dispatch order: the hung window need not be
                    # the queue head (it may have overtaken earlier
                    # lower-lane windows)
                    try:
                        self._windows.remove(win)
                    except ValueError:
                        pass
                if not self._windows:
                    # the hung window was the whole queue: the drain
                    # ends here, same as _device_loop's post-resolve —
                    # otherwise the fault latch outlives the outage and
                    # a probed-healthy chip never gets work again
                    self._faulted = False
                self.resolved += 1
                self._cv.notify_all()
            self._slots.release()
            self._record_flush(win, "drain",
                               win.dispatch_started or now)
            self._gauge()
        else:
            # mesh: park the verdicts on the window and let the
            # in-order publisher resolve it (submission-order contract)
            with self._cv:
                win.result = (ok, verdicts, "drain")
            self._record_flush(win, "drain",
                               win.dispatch_started or now)
            self._publish_resolved(idx)

    def _handle_probe_hang(self, dev: str, now: float) -> None:
        with self._cv:
            entry = self._probe_inflight.pop(dev, None)
            if entry is None:
                return
            t0, win = entry
            waited = now - t0
            gen = self._gens.get(dev, 0) + 1
            self._gens[dev] = gen
        idx = int(dev) if self.devices is not None else None
        self._spawn_dispatch_thread(idx, gen)
        self._record_watchdog(dev, win, waited, 0)
        # a hung probe is a failed probe: stay quarantined, back off
        self.health.probe_result(dev, "fail")
        self._check_brownout()

    def _spawn_dispatch_thread(self, idx: int | None,
                               gen: int) -> None:
        # the replacement makes its device current as the first thread
        # did (_run_dispatch_loop).  A thread wedged in a CUDA wait
        # cannot be killed: its queued work stays on the stream, and the
        # replacement's launches queue behind it.
        if idx is None:
            th = threading.Thread(
                target=self._run_dispatch_loop, args=(None, gen),
                name=f"{self._name}-device-r{gen}", daemon=True)
            self._device = th
        else:
            th = threading.Thread(
                target=self._run_dispatch_loop, args=(idx, gen),
                name=f"{self._name}-device-{idx}-r{gen}", daemon=True)
            self._dev_threads.append(th)
        th.start()

    def _record_watchdog(self, dev: str, win: _Window, waited: float,
                         staged_behind: int) -> None:
        from ..libs import flightrec
        from ..libs import metrics as libmetrics

        dm = libmetrics.device_metrics()
        if dm is not None:
            dm.watchdog_timeouts.labels(dev).inc()
        flightrec.record(flightrec.EV_WATCHDOG_TIMEOUT, device=dev,
                         batch=len(win.items), waited_s=round(waited, 3),
                         deadline_s=self.dispatch_deadline_s,
                         staged=staged_behind,
                         subsystem=win.handle.subsystem)
        rec = flightrec.recorder()
        if rec is not None:
            rec.dump_to_log(
                "pipeline dispatch hung on device %s (%.1fs > %.1fs "
                "deadline), host-resolving" %
                (dev, waited, self.dispatch_deadline_s))

    # -- recovery probes (known-answer batches) --------------------------

    def _probe_due_locked(self, dev: str) -> bool:
        """Called under self._cv from the dispatch wait loops: True
        when this quarantined device's probe backoff has elapsed (the
        health registry flips it to PROBING as a side effect)."""
        if self._stopping or dev in self._probe_inflight:
            return False
        return self.health.due_probe(dev)

    def _run_probe(self, dev: str, device, gen: int) -> None:
        """Dispatch the known-answer probe batch on a quarantined
        device.  Expected verdicts (one lane deliberately corrupt)
        must match EXACTLY — a chip that forges or flips lanes stays
        benched.  Probe verdicts never touch the verdict cache."""
        from . import devhealth as _devhealth
        from ..libs import devprof
        from ..libs import trace as libtrace
        from ..libs import tracetl

        if self._stopping:
            self.health.transition(dev, "quarantined")
            return
        win = self._make_probe_window(dev)
        with self._cv:
            self._probe_inflight[dev] = (time.monotonic(), win)
        passed = False
        try:
            with libtrace.span("pipeline", "device_probe",
                               device=dev), \
                    tracetl.span_for(self, "pipeline", "device_probe",
                                     device=dev):
                _ok, verdicts = self._device_dispatch(
                    win, device=device)
            passed = [bool(v) for v in verdicts] == \
                _devhealth.probe_expected()
        except KernelBuildError as e:
            # no caller waits on a probe's handle: the flight recorder
            # keeps the error, and the device stays benched, as a failed
            # probe leaves it
            from ..libs import flightrec

            flightrec.record(flightrec.EV_DEVICE_PROBE, device=dev,
                             result="build_error",
                             error=type(e).__name__, detail=repr(e))
            passed = False
        except Exception:
            passed = False
        with self._cv:
            self._probe_inflight.pop(dev, None)
            stale = gen != self._gens.get(dev, 0)
        if stale:
            # the watchdog already failed this probe and replaced us
            return
        rec = devprof.recorder()
        if rec is not None:
            rec.advance(dev, devprof.BUSY, path="probe")
        if passed:
            self.health.probe_result(dev, "ok")
        else:
            self.health.probe_result(dev, "fail")
        self._check_brownout()

    def _make_probe_window(self, dev: str) -> _Window:
        """Hand-staged known-answer window: bypasses _stage (whose
        provider/threshold gates would route it to the host — the
        whole point is to exercise the DEVICE path)."""
        from . import devhealth as _devhealth
        from . import ed25519 as ed

        items = list(_devhealth.probe_items())
        handle = WindowHandle(len(items), "probe", None)
        win = _Window(items, handle, 1)
        pks = [_pk_bytes(pk) for pk, _, _ in items]
        msgs = [m for _, m, _ in items]
        sigs = [s for _, _, s in items]
        win.pks = pks
        win.parsed = ed.parse_and_hash(pks, msgs, sigs)
        win.packed = ed.pack_rlc(pks, [b""] * len(pks),
                                 [b""] * len(pks), parsed=win.parsed)
        win.mode = "ed"
        win.staged = True
        win.device_index = int(dev) if self.devices is not None else 0
        return win


# -- process-wide default instance ------------------------------------------

_default: VerifyPipeline | None = None
_default_lock = lockrank.RankedLock("dispatch.default")


def default_pipeline(device="cuda") -> VerifyPipeline:
    """Lazily started shared engine: all product paths in a process
    share one ordered dispatch queue.  Raises without a card unless
    device="cpu"; asking for another device than the running default's
    raises ValueError."""
    from ..ops import device as devmod

    global _default
    dev = devmod.resolve(device)
    with _default_lock:
        if _default is None or not _default.is_running():
            _default = VerifyPipeline(device=dev)
            _default.start()
        elif _default.device != dev:
            raise ValueError(f"the default pipeline runs on "
                             f"{_default.device}, not {dev}")
        return _default
