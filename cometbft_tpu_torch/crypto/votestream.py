"""Streaming signature verification: the deadline-flushed accumulator
between live consensus and the card (the port's copy of
`cometbft_tpu.crypto.votestream`; the per-vote hot path is CometBFT's
types/vote_set.go:219-232 -> ed25519.go:181).

Gossiped votes are PRE-verified off the consensus-state thread: the
reactor submits (pubkey, sign_bytes, sig) as soon as a VoteMessage
arrives and attaches the resulting future to the vote; VoteSet.add_vote
consumes the verdict if (and only if) the submitted triple matches what
it would itself verify.  The verifier batches concurrent submissions:

- a worker collects submissions until the oldest has waited
  flush_interval (on the injectable `clock`), the batch hits max_batch,
  or the pipeline's QoS scheduler advises sealing now
  (VerifyPipeline.qos_seal_due("consensus"): work of another priority
  class is queued);
- small flushes take the host path, one signature at a time
  (crypto/ed25519.PubKey.verify_signature, pure-Python ZIP-215);
- flushes of device_threshold votes and more go to the card as one
  window on the verify pipeline's consensus lane
  (crypto/dispatch.VerifyPipeline -> crypto/batch._device_verify: the
  RLC program on K1-K4, and K1 + K14 to localize a reject).

Two fast exits come before a batch slot: a verdict-cache hit
(crypto/sigcache.py) resolves at submit, and a triple already queued
shares the queued future (a second peer gossiping the same vote).

The device: `device` (default "cuda") resolves through
ops/device.resolve when the verifier is made, so without a card it
raises unless the caller passes device="cpu" (the kernels' plain
versions).  Device flushes go through dispatch.default_pipeline(device)
or an injected pipeline, which must run on the same device.  The
pre-warm, one window of min(device_threshold, 256) distinct keys at
start, runs by default exactly when the device is a card.

A kernel that does not build (ops/_build.KernelBuildError) is no device
fault: every vote future of its batch raises it, the flight recorder
keeps it, and no vote of the batch is verified on the host.  Any other
exception while submitting or resolving a device window routes the batch
to the host, as in the JAX package, recorded (EV_DEVICE_FALLBACK) and
counted apart (device_fallbacks).

The JAX package's environment variables are module constants here, with
the constructor's parameters for a second value.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future

from ..libs import lockrank
from ..libs.service import BaseService
from ..ops._build import KernelBuildError

# COMETBFT_TPU_VOTE_FLUSH_MS: how long the oldest vote may wait for
# more to batch with
FLUSH_INTERVAL_S = 0.002
# COMETBFT_TPU_VOTE_DEVICE_THRESHOLD: flushes of this many votes and
# more go to the card
DEVICE_THRESHOLD = 256
# COMETBFT_TPU_VOTE_PREWARM: True / False, or None to warm exactly when
# the verifier's device is a card
PREWARM: bool | None = None
MAX_BATCH = 4096
# how often the accumulating worker re-checks the pipeline's QoS seal
# advisory while a batch forms; only matters when flush_interval is
# large relative to it.  5 ms keeps the worker's wake rate low (the
# advisory's empty-queue fast path is a couple of attribute reads)
# while staying well inside the 50 ms consensus SLO
_SEAL_POLL_S = 0.005
# the pre-warm window's wait: it may build the kernels (ops/_build.py,
# ~20 s with nvcc on a fresh build directory)
_PREWARM_TIMEOUT_S = 600.0


def _same_device(a, b) -> bool:
    """One device, where "cuda" without an index matches any card."""
    import torch

    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


class StreamingVerifier(BaseService):
    """Deadline-flushed ed25519 verify accumulator."""

    def __init__(self, flush_interval: float | None = None,
                 device_threshold: int | None = None,
                 max_batch: int = MAX_BATCH, pipeline=None,
                 warmup: bool | None = None, device="cuda",
                 clock=time.monotonic):
        from ..ops import device as devmod

        super().__init__("StreamingVerifier")
        self.device = devmod.resolve(device)
        pdev = getattr(pipeline, "device", None)
        if pdev is not None and not _same_device(self.device, pdev):
            raise ValueError(f"the verifier runs on {self.device}, its "
                             f"pipeline on {pdev}")
        self.flush_interval = (FLUSH_INTERVAL_S if flush_interval is None
                               else flush_interval)
        self.device_threshold = (DEVICE_THRESHOLD if device_threshold
                                 is None else device_threshold)
        self.max_batch = max_batch
        # the accumulation deadline's clock (tests inject a fake one)
        self._clock = clock
        # overlapped dispatch engine (crypto/dispatch.py); None = the
        # process-wide default on this device, made at the first device
        # flush
        self._pipeline = pipeline
        # pre-warm the device vote path at start (_prewarm); None defers
        # to PREWARM, and then warms only on a card
        self.warmup = warmup
        self.warmed = threading.Event()
        # what stopped the pre-warm window, kept for the caller
        self.warm_error: BaseException | None = None
        # (pubkey, msg, sig, future, trace_ctx_or_None, latledger_req)
        self._pending: list[tuple] = []
        # in-flight dedupe: triple -> the future already queued for it,
        # so two peers flooding the same vote share one batch slot
        self._inflight: dict[tuple, Future] = {}
        self._cv = lockrank.RankedCondition(name="votestream.cv")
        self._thread: threading.Thread | None = None
        self._stopping = False
        self.flushes = 0
        self.device_flushes = 0
        self.verified = 0
        self.coalesced = 0
        self.cache_hits = 0
        # flushes and votes by path: "host", "device" (submitted to the
        # pipeline) and "cache" (a flush the cache answered whole)
        self.path_flushes = collections.Counter()
        self.path_votes = collections.Counter()
        # the resolution path of each device window (device / cache /
        # drain / host / error), as its handle reports it
        self.window_paths = collections.Counter()
        # batches routed to the host after a device exception, and
        # batches failed by a KernelBuildError
        self.device_fallbacks = 0
        self.build_errors = 0

    # -- service -----------------------------------------------------------

    def on_start(self) -> None:
        self._stopping = False
        self._thread = threading.Thread(
            target=self._worker, name="vote-verify-stream", daemon=True)
        self._thread.start()
        if self._should_warm():
            threading.Thread(target=self._prewarm,
                             name="vote-verify-warmup",
                             daemon=True).start()
        else:
            self.warmed.set()

    def _should_warm(self) -> bool:
        if self.warmup is not None:
            return self.warmup
        if PREWARM is not None:
            return PREWARM
        # on the CPU the pre-warm runs the plain versions, seconds of
        # work that warm nothing
        return self.device.type == "cuda"

    def _pipe(self):
        if self._pipeline is not None:
            return self._pipeline
        from .dispatch import default_pipeline

        return default_pipeline(self.device)

    def _prewarm(self) -> None:
        """Build the kernels and dispatch one window of distinct keys at
        start, so that the first real vote flood meets warm kernels (the
        first use builds them inside a dispatch, ops/_build.py).
        Distinct keys size the A-side MSM width like a real
        device_threshold-sized flood."""
        try:
            from . import ed25519_ref as ref

            n = max(2, min(self.device_threshold, 256))
            items = []
            for i in range(n):
                seed, pub = ref.keygen(i.to_bytes(32, "little"))
                msg = b"cometbft-tpu-vote-prewarm-" + i.to_bytes(
                    4, "little")
                items.append((pub, msg, ref.sign(seed, msg)))
            # lat=() opts the warmup window out of the latency ledger:
            # a build-time row would poison the consensus p99
            handle = self._pipe().submit(items, subsystem="consensus",
                                         device_threshold=2, lat=())
            handle.result(timeout=_PREWARM_TIMEOUT_S)
        except BaseException as e:      # noqa: BLE001 - kept, not lost
            self.warm_error = e
        finally:
            self.warmed.set()

    def on_stop(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2)

    # -- API ---------------------------------------------------------------

    def submit(self, pubkey: bytes, msg: bytes, sig: bytes,
               ctx=None) -> Future:
        """Queue one signature; the future resolves to a bool verdict.
        The caller keeps (pubkey, msg, sig) to check the verdict applies
        to what it meant to verify.  ``ctx`` is an optional trace
        context (libs/tracetl.py) tagging the flush events with the
        consensus height/round that triggered the verify.

        Two fast exits before a batch slot is occupied:
        - verdict-cache hit (crypto/sigcache.py): the triple was
          already proved somewhere in the process — the returned
          future is ALREADY RESOLVED;
        - in-flight duplicate: the same triple is already queued (a
          second peer flooding the same vote) — the existing future is
          returned, one verification serves both."""
        from . import sigcache
        from ..libs import latledger

        fut: Future = lockrank.TrackedFuture()
        # one latency-ledger request per submitted vote: resolved at
        # whichever seam answers (cache here, host/device at flush, or
        # coalesced onto the original's resolution)
        req = latledger.submit(1, consumer="consensus")
        if sigcache.enabled():
            v = sigcache.get(pubkey, msg, sig, key_type="ed25519",
                             label="consensus")
            if v is not None:
                self.cache_hits += 1
                fut.set_result(v)
                if req is not None:
                    req.resolve("cache")
                return fut
        with self._cv:
            if self._stopping or self._thread is None:
                fut.set_result(_host_verify(pubkey, msg, sig))
                if req is not None:
                    req.resolve("host")
                return fut
            triple = (pubkey, msg, sig)
            existing = self._inflight.get(triple)
            if existing is not None and not existing.done():
                self.coalesced += 1
                from ..libs import metrics as libmetrics

                cm = libmetrics.cache_metrics()
                if cm is not None:
                    cm.votestream_coalesced.inc()
                if req is not None:
                    # the duplicate's whole wait is the original's
                    # resolution: its row lands as coalesce_wait, and
                    # the original keeps its own decomposition
                    existing.add_done_callback(
                        lambda f, r=req: r.resolve_coalesced())
                return existing
            self._inflight[triple] = fut
            # the done-callback fires on resolve AND on cancel, so a
            # canceled slot stops absorbing new duplicates
            fut.add_done_callback(
                lambda f, t=triple: self._forget(t, f))
            self._pending.append((pubkey, msg, sig, fut, ctx, req))
            self._cv.notify()
        return fut

    def _forget(self, triple: tuple, fut: Future) -> None:
        with self._cv:
            if self._inflight.get(triple) is fut:
                del self._inflight[triple]

    def _seal_due(self) -> bool:
        """QoS preemption signal (VerifyPipeline.qos_seal_due): should
        the in-formation vote window seal now instead of waiting out
        the flush interval?  Peeks the pipeline this verifier would
        flush through — WITHOUT lazily creating one — and defers to
        its scheduler.  Rank-legal under self._cv: votestream.cv
        orders below dispatch.cv (libs/lockrank.py)."""
        pipe = self._pipeline
        if pipe is None:
            from . import dispatch

            pipe = dispatch._default
        # getattr: injected test pipelines are plain stubs with only
        # submit(); no advisory means no early seal
        seal = getattr(pipe, "qos_seal_due", None) \
            if pipe is not None else None
        if seal is None:
            return False
        return seal("consensus")

    # -- worker ------------------------------------------------------------

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stopping:
                    self._cv.wait(timeout=0.1)
                if self._stopping:
                    batch, self._pending = self._pending, []
                else:
                    # deadline accumulation: let the batch grow until the
                    # OLDEST submission has waited flush_interval — or
                    # until the pipeline's QoS scheduler says sealing
                    # now beats batching further (cross-class work is
                    # queued behind us), so a single late vote never
                    # rides out the full interval behind a blocksync
                    # burst
                    deadline = self._clock() + self.flush_interval
                    while (len(self._pending) < self.max_batch
                           and not self._stopping):
                        left = deadline - self._clock()
                        if left <= 0:
                            break
                        if self._seal_due():
                            break
                        self._cv.wait(timeout=min(left, _SEAL_POLL_S))
                    batch, self._pending = self._pending, []
            if batch:
                self._flush(batch)
            if self._stopping:
                with self._cv:
                    leftover, self._pending = self._pending, []
                if leftover:
                    self._flush(leftover)
                return

    def _flush(self, batch) -> None:
        from . import sigcache
        from ..libs import devprof as libdevprof

        # devprof accounting (libs/devprof.py): below device_threshold
        # the worker thread IS the verify engine — account it under
        # device "0" like the pipeline's single-device loop does.  The
        # gap since the last mark was spent collecting the batch (or the
        # cache absorbed the whole flush): the engine was starved of
        # work, not slow: no_work.
        dp = libdevprof.recorder()
        if dp is not None:
            dp.advance("0", libdevprof.IDLE_NO_WORK)

        # consumers cancel futures they already verified inline
        batch = [b for b in batch if not b[3].cancelled()]
        if not batch:
            return
        # late cache hits: verdicts inserted since submit (blocksync,
        # a previous flush, an inline verify) resolve here without
        # occupying a batch slot.  Misses were already counted at
        # submit time, so this re-check only accounts hits.
        cache_hits = 0
        if sigcache.enabled():
            verdicts, miss_idx = sigcache.partition(
                [(b[0], b[1], b[2]) for b in batch],
                label="consensus", count_misses=False)
            for b, v in zip(batch, verdicts):
                if v is not None and b[3].set_running_or_notify_cancel():
                    b[3].set_result(v)
                    if b[5] is not None:
                        b[5].resolve("cache")
            cache_hits = len(batch) - len(miss_idx)
            batch = [batch[i] for i in miss_idx]
            if not batch:
                self.path_flushes["cache"] += 1
                self.path_votes["cache"] += cache_hits
                return
        self.flushes += 1
        self.verified += len(batch)
        from ..libs import flightrec
        from ..libs import metrics as libmetrics
        from ..libs import trace as libtrace
        from ..libs import tracetl

        t0 = time.monotonic()
        if len(batch) >= self.device_threshold:
            try:
                # submit() is non-blocking past backpressure: the worker
                # returns to COLLECTING the next batch while this window
                # packs and dispatches
                with libtrace.span("consensus", "verify_dispatch"), \
                        tracetl.span_for(self, "consensus",
                                         "verify_dispatch",
                                         cache=cache_hits):
                    self._flush_device(batch)
                self.path_flushes["device"] += 1
                self.path_votes["device"] += len(batch)
                return
            except KernelBuildError as e:
                self._fail_batch(batch, e)
                return
            except Exception as e:
                # submit-time trouble: host verdicts are still correct,
                # but the operator must be able to see it
                self._record_fallback(batch, e)
        path = "host"
        with libtrace.span("consensus", "verify_dispatch"), \
                tracetl.span_for(self, "consensus", "verify_dispatch",
                                 cache=cache_hits):
            for pk, msg, sig, fut, _, req in batch:
                # verdict first, future second: a consumer that
                # cancel-raced this flush (Preverified.verdict_for)
                # still gets the verdict CACHED, so its inline
                # re-verify is the last time the triple costs anything
                if req is not None:
                    req.stamp("dispatch")
                v = _host_verify(pk, msg, sig)
                sigcache.insert(pk, msg, sig, v, key_type="ed25519",
                                label="consensus")
                if req is not None:
                    req.stamp("compute_end")
                if fut.set_running_or_notify_cancel():
                    fut.set_result(v)
                if req is not None:
                    req.resolve(path)
        self.path_flushes[path] += 1
        self.path_votes[path] += len(batch)
        if dp is not None:
            dp.advance("0", libdevprof.BUSY, path=path)
        dm = libmetrics.device_metrics()
        if dm is not None:
            dm.flushes.labels(path).inc()
            dm.batch_size.labels(path).observe(len(batch))
            dm.flush_latency_seconds.labels(path).observe(
                time.monotonic() - t0)
        flightrec.record(flightrec.EV_VERIFY_FLUSH, path=path,
                         batch=len(batch), inflight=0, staged=0,
                         cache_hits=cache_hits,
                         **tracetl.ctx_fields(_batch_ctx(batch)))

    def _record_fallback(self, batch, exc: BaseException) -> None:
        from ..libs import flightrec

        self.device_fallbacks += 1
        rec = flightrec.recorder()
        if rec is not None:
            rec.record(flightrec.EV_DEVICE_FALLBACK, batch=len(batch),
                       error=type(exc).__name__)
            rec.dump_to_log("device verify flush failed: %r" % exc)

    def _fail_batch(self, batch, exc: BaseException,
                    resolve_lat: bool = True) -> None:
        """A kernel that does not build: every vote future of the batch
        raises it, and the flight recorder keeps it.  resolve_lat=False
        where the window that carried the ledger requests already
        resolved them."""
        from ..libs import flightrec
        from ..libs import tracetl

        self.build_errors += 1
        flightrec.record(flightrec.EV_VERIFY_FLUSH, path="error",
                         batch=len(batch), error=type(exc).__name__,
                         detail=repr(exc),
                         **tracetl.ctx_fields(_batch_ctx(batch)))
        for _, _, _, fut, _, req in batch:
            if fut.set_running_or_notify_cancel():
                fut.set_exception(exc)
            if req is not None and resolve_lat:
                req.resolve("error")

    def _flush_device(self, batch) -> None:
        """Submit the batch through the overlapped pipeline and resolve
        the vote futures from its completion callback; the pipeline
        records the flush metrics / flight-recorder event when the
        window resolves."""
        self.device_flushes += 1
        pipe = self._pipe()
        # the per-vote ledger requests ride the window: the pipeline
        # stamps staging/dispatch/compute and resolves each with the
        # window's path, so queue_wait covers the pending-queue wait
        # from the ORIGINAL submit, not the flush
        lat = [b[5] for b in batch if b[5] is not None] or None
        # the stream has decided this batch goes to the card: a stream
        # made with device_threshold=1 sends a single vote there too
        # (K1 + K14, no RLC program), where the JAX package's pipeline
        # threshold of 2 would send it to the host
        handle = pipe.submit(
            [(pk, msg, sig) for pk, msg, sig, *_ in batch],
            subsystem="consensus", device_threshold=1,
            ctx=_batch_ctx(batch), lat=lat)

        def _resolve(h):
            from . import sigcache

            self.window_paths[getattr(h, "path", None) or "error"] += 1
            try:
                _, verdicts = h.result(timeout=0)
            except KernelBuildError as e:
                self._fail_batch(batch, e, resolve_lat=False)
                return
            except Exception as e:
                self._record_fallback(batch, e)
                verdicts = None
            if verdicts is None:
                for pk, msg, sig, fut, _, _ in batch:
                    v = _host_verify(pk, msg, sig)
                    sigcache.insert(pk, msg, sig, v,
                                    key_type="ed25519",
                                    label="consensus")
                    if fut.set_running_or_notify_cancel():
                        fut.set_result(v)
                return
            # verdicts for cancel-raced futures were inserted into the
            # verdict cache by the pipeline at window publication —
            # nothing re-verifies them even though set_running fails
            for (_, _, _, fut, _, _), ok in zip(batch, verdicts):
                if fut.set_running_or_notify_cancel():
                    fut.set_result(bool(ok))

        handle.add_done_callback(_resolve)


def _batch_ctx(batch):
    """First non-None trace context in the batch: a flush is one event,
    and the oldest submission is the one whose latency it bounds."""
    for entry in batch:
        if entry[4] is not None:
            return entry[4]
    return None


def _host_verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    """One signature on the host (pure-Python ZIP-215); a malformed key
    or signature is invalid."""
    from .ed25519 import PUBKEY_SIZE, PubKey

    if len(pk) != PUBKEY_SIZE:
        return False
    try:
        return PubKey(pk).verify_signature(msg, sig)
    except Exception:
        return False


# -- process-wide default instance ------------------------------------------

_default: StreamingVerifier | None = None
_default_lock = lockrank.RankedLock("votestream.default")


def default_verifier(device="cuda") -> StreamingVerifier:
    """Lazily started shared instance (all reactors in a process feed
    one accumulator, maximizing batch opportunities).  Raises without a
    card unless device="cpu"; asking for another device than the
    running default's raises ValueError."""
    from ..ops import device as devmod

    global _default
    dev = devmod.resolve(device)
    with _default_lock:
        if _default is None or not _default.is_running():
            _default = StreamingVerifier(device=dev)
            _default.start()
        elif not _same_device(_default.device, dev):
            raise ValueError(f"the default verifier runs on "
                             f"{_default.device}, not {dev}")
        return _default


class Preverified:
    """Verdict attached to a Vote by the reactor: the consumed-by
    VoteSet contract is exact-triple equality."""

    __slots__ = ("pubkey", "msg", "sig", "future")

    def __init__(self, pubkey: bytes, msg: bytes, sig: bytes,
                 future: Future):
        self.pubkey = pubkey
        self.msg = msg
        self.sig = sig
        self.future = future

    def verdict_for(self, pubkey: bytes, msg: bytes, sig: bytes):
        """Bool verdict if this preverification covers (pubkey, msg,
        sig) exactly AND already resolved; None otherwise.  Never
        blocks: a pending future is CANCELED (dropping it from the
        worker's batch — no duplicated work) and the caller verifies
        inline.  During floods the state thread lags the verifier and
        futures are resolved by the time they are consumed — that is
        the case this path accelerates.  A KernelBuildError raises: an
        inline verify would hide a broken install."""
        if (pubkey, msg, sig) != (self.pubkey, self.msg, self.sig):
            return None
        fut = self.future
        if fut.done() and not fut.cancelled():
            try:
                return bool(fut.result(timeout=0))
            except KernelBuildError:
                raise
            except Exception:
                return None
        fut.cancel()
        return None
