"""LightServeSession: the serving-plane facade (the port's copy of
`cometbft_tpu.lightserve.session`).

One session serves skipping-sync requests over one node's stores:

    plan (planner) -> verify once per height (coalescer -> one merged
    DeferredSigBatch window through the VerifyPipeline, labeled
    ``sigcache.consumer("lightserve")``) -> serve cached payload bytes.

The session runs its windows on `device` (default "cuda"): without a
card it raises unless the caller passes device="cpu", which runs the
kernels' plain versions.  Only a height whose commit does not verify
(HEIGHT_FAULTS, or a signature the window's verdict rejects) is blamed
on that height; any other exception, such as a kernel that does not
build (ops/_build.KernelBuildError) or a device fault, fails the
window's requests and blames no height.
"""

from __future__ import annotations

import time

from ..crypto import sigcache
from ..libs import flightrec, lockrank
from ..libs import metrics as libmetrics
from ..libs.trace import span as trace_span
from ..ops import device as devmod
from ..types import validation
from . import codec
from .coalesce import RequestCoalescer
from .planner import TrustPathPlanner

# every PREFETCH_EVERY requests the planner re-encodes the hot paths
# against the current tip: cheap (cache-guarded) and keeps the hot
# frontier tracking a moving chain without a dedicated thread
PREFETCH_EVERY = 64
# the JAX package's default: requests coalesce
DEFAULT_COALESCE = True


class LightServeError(Exception):
    pass


# a height that cannot be served from the stores or whose commit does not
# verify: the height's requests fail, the window's other heights do not
HEIGHT_FAULTS = (LightServeError, validation.CommitVerificationError,
                 KeyError, ValueError)


class LightServeSession:
    def __init__(self, block_store, state_store, chain_id: str, *,
                 coalesce: bool | None = None,
                 window_ms: float | None = None,
                 max_batch: int | None = None,
                 pipeline=None, planner: TrustPathPlanner | None = None,
                 start: bool = True, device="cuda"):
        self.device = devmod.resolve(device)
        self.block_store = block_store
        self.state_store = state_store
        self.chain_id = chain_id
        self.coalesce = DEFAULT_COALESCE if coalesce is None \
            else bool(coalesce)
        self._pipe = pipeline
        self.planner = planner if planner is not None \
            else TrustPathPlanner()
        self._mtx = lockrank.RankedLock("lightserve.session")
        self._closed = False
        self.requests = 0
        self.headers_served = 0
        self.verify_windows = 0
        self.verify_sigs = 0
        self.failed_heights = 0
        self.coalescer: RequestCoalescer | None = None
        if self.coalesce:
            self.coalescer = RequestCoalescer(
                self._verify_heights, window_ms=window_ms,
                max_batch=max_batch, start=start)

    # -- verify plane ------------------------------------------------------

    def _pipeline(self):
        if self._pipe is None:
            from ..crypto import dispatch

            self._pipe = dispatch.default_pipeline(self.device)
        return self._pipe

    def _commit_for(self, height: int):
        commit = self.block_store.load_block_commit(height)
        if commit is None:
            commit = self.block_store.load_seen_commit(height)
        return commit

    def _verify_heights(self, heights, lane: str | None = None) -> dict:
        """Verify one merged batch of heights: host-side structure and
        voting-power tallies per commit, then ONE deferred window through
        the pipeline.  Returns {height: Exception | None}: per-height
        blame, so one forged commit in a merged flush fails only the
        requests that needed that height.  `lane` (from the coalescer:
        the most urgent claimant's consumer) re-lanes the window's QoS
        priority; attribution stays lightserve."""
        out: dict = {h: None for h in heights}
        db = validation.DeferredSigBatch()
        with trace_span("lightserve", "collect", heights=len(out)):
            for h in heights:
                try:
                    commit = self._commit_for(h)
                    vals = self.state_store.load_validators(h)
                    if commit is None or vals is None:
                        raise LightServeError(
                            f"height {h} not in store")
                    validation.verify_commit_light(
                        self.chain_id, vals, commit.block_id, h,
                        commit, defer_to=db, device=self.device)
                except HEIGHT_FAULTS as exc:
                    out[h] = exc
        nsigs = db.count()
        lm = libmetrics.lightserve_metrics()
        with trace_span("lightserve", "verify_dispatch", sigs=nsigs), \
                sigcache.consumer("lightserve"):
            verdict = db.verify_async(self._pipeline(),
                                      subsystem="lightserve",
                                      lane=lane)
            bad = verdict.failed_contexts()
        if nsigs:
            self.verify_windows += 1
            self.verify_sigs += nsigs
            if lm is not None:
                lm.verify_windows_total.inc()
                lm.verify_sigs_total.inc(nsigs)
        for h in bad:
            self.failed_heights += 1
            out[h] = validation.ErrInvalidSignature(
                f"invalid signature in commit at height {h}")
            flightrec.record(flightrec.EV_LIGHTSERVE_REJECT, height=h)
        return out

    # -- payload plane -----------------------------------------------------

    def _encode_payload(self, height: int) -> bytes | None:
        meta = self.block_store.load_block_meta(height)
        commit = self._commit_for(height)
        vals = self.state_store.load_validators(height)
        if meta is None or commit is None or vals is None:
            return None
        return codec.encode_payload(height, meta.header, commit, vals)

    def payload_bytes(self, height: int) -> bytes:
        blob = self.planner.payload(height)
        if blob is None:
            blob = self._encode_payload(height)
            if blob is None:
                raise LightServeError(
                    f"height {height} not in store")
            self.planner.put_payload(height, blob)
        return blob

    def prefetch_hot(self, target: int | None = None,
                     top_n: int = 8) -> int:
        """Planner-driven prefetch: encode the hot trust paths' payloads
        ahead of demand."""
        tip = self.block_store.height() if target is None else target
        n = self.planner.prefetch(tip, self._encode_payload, top_n)
        if n:
            lm = libmetrics.lightserve_metrics()
            if lm is not None:
                lm.prefetched_headers_total.inc(n)
        return n

    # -- serve path --------------------------------------------------------

    def _resolve_heights(self, trusted_height, target_height):
        tip = self.block_store.height()
        base = self.block_store.base()
        target = tip if target_height in (None, "", 0) \
            else int(target_height)
        trusted = base if trusted_height in (None, "") \
            else int(trusted_height)
        if trusted < 1:
            raise LightServeError(
                f"trusted_height must be positive, got {trusted}")
        if target > tip or target < base:
            raise LightServeError(
                f"target height {target} outside [{base}, {tip}]")
        if trusted >= target:
            raise LightServeError(
                f"trusted height {trusted} must be below target "
                f"{target}")
        return trusted, target

    def serve(self, trusted_height, target_height=None):
        """Verify and serve one request's path; returns (path, [payload
        bytes per path height]).  Raises on any verification failure:
        nothing is served past a bad height."""
        t0 = time.perf_counter()
        if self._closed:
            raise LightServeError("session is closed")
        trusted, target = self._resolve_heights(trusted_height,
                                                target_height)
        path = self.planner.plan(trusted, target)
        self.requests += 1
        lm = libmetrics.lightserve_metrics()
        if lm is not None:
            lm.requests_total.inc()
        if self.coalescer is not None:
            self.coalescer.acquire(path).wait()
        else:
            results = self._verify_heights(path)
            for h in path:
                if results[h] is not None:
                    raise results[h]
        blobs = [self.payload_bytes(h) for h in path]
        self.headers_served += len(path)
        if lm is not None:
            lm.headers_served_total.inc(len(path))
            lm.serve_seconds.observe(time.perf_counter() - t0)
        if self.requests % PREFETCH_EVERY == 0:
            self.prefetch_hot(target)
        return path, blobs

    def sync(self, trusted_height=None, target_height=None) -> dict:
        """The light_sync RPC result: the verified path and its light
        blocks, decoded from the same canonical bytes ``serve`` hands
        the wire."""
        trusted, target = self._resolve_heights(trusted_height,
                                                target_height)
        path, blobs = self.serve(trusted, target)
        return {
            "trusted_height": str(trusted),
            "target_height": str(target),
            "path": [str(h) for h in path],
            "light_blocks": [codec.decode_payload(b) for b in blobs],
            "coalesced": self.coalesce,
        }

    def status(self) -> dict:
        cstats = self.coalescer.stats() if self.coalescer is not None \
            else {}
        return {
            "coalescing": self.coalesce,
            "chain_id": self.chain_id,
            "latest_height": str(self.block_store.height()),
            "base_height": str(self.block_store.base()),
            "requests": str(self.requests),
            "headers_served": str(self.headers_served),
            "verify_windows": str(self.verify_windows),
            "verify_sigs": str(self.verify_sigs),
            "failed_heights": str(self.failed_heights),
            "coalesced_heights": str(cstats.get("coalesced", 0)),
            "inflight_heights": str(cstats.get("inflight_heights", 0)),
            "planner": {k: str(v)
                        for k, v in self.planner.stats().items()},
        }

    def close(self) -> None:
        with self._mtx:
            if self._closed:
                return
            self._closed = True
        if self.coalescer is not None:
            self.coalescer.close()
