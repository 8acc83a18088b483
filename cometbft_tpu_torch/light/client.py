"""Light client with bisection and witness cross-checking (the port's copy
of `cometbft_tpu.light.client`; CometBFT light/client.go).

Sync strategies:
- sequential: verify every header from the trusted one to the target;
  the commits' signatures collect into one DeferredSigBatch a window of
  `sequential_batch_size` headers, verified on the card as one RLC
  program (K1-K4), either window by window (`pipeline_depth` 1) or
  overlapped through a VerifyPipeline (the next window fetched and
  collected while the last is on the card);
- skipping (the default): try the target against the latest trusted
  block; when too little of the trusted set signed it, fetch a pivot at
  9/16 of the span and recurse, keeping what was fetched;
- backwards: hash-chain down from the first trusted block.

A rejected window is localized by the per-signature program (K1 + K14).
`Client(device=)` (default "cuda") is the device of every verify, of the
pipeline and of every valset hash; without a card it raises unless given
device="cpu".
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

from ..crypto import sigcache
from ..libs.trace import span as trace_span
from ..ops import device as devmod
from ..types.timestamp import Timestamp
from ..types.validation import Fraction
from . import verifier
from .provider import (
    ErrHeightTooHigh, ErrLightBlockNotFound, ErrNoResponse, Provider,
    ProviderError,
)
from .store import MemoryStore, Store
from .types import LightBlock
from .verifier import (
    DEFAULT_TRUST_LEVEL, ErrNewValSetCantBeTrusted, LightClientError, SECOND,
)

SEQUENTIAL = "sequential"
SKIPPING = "skipping"

# the bisection pivot, 9/16 of the span (client.go)
_SKIP_NUM = 9
_SKIP_DEN = 16

DEFAULT_PRUNING_SIZE = 1000

# QoS lane for the light client's verify windows (crypto/sched.py); empty
# is the light lane itself.  Another lane changes the dispatch priority
# only: trace, ledger and cache attribution stay "light".
SCHED_LANE = os.environ.get(
    "COMETBFT_TPU_SCHED_LIGHT_LANE", "") or None


@dataclass
class TrustOptions:
    """The trust root: period, height and hash."""

    period_ns: int
    height: int
    hash: bytes

    def validate_basic(self) -> None:
        if self.period_ns <= 0:
            raise ValueError("trusting period must be > 0")
        if self.height <= 0:
            raise ValueError("trusted height must be > 0")
        if len(self.hash) != 32:
            raise ValueError("expected 32-byte trusted hash")


class ErrLightClientAttack(LightClientError):
    def __init__(self, evidence):
        super().__init__("light client attack detected")
        self.evidence = evidence


class _WindowPrefetcher:
    """One daemon worker that fetches the next window while the current
    one verifies.  close() cancels queued fetches and joins the worker
    within a bound: a fetch blocked inside a dead provider cannot wedge
    the caller or interpreter shutdown, and its future's eventual
    exception is consumed so that nothing leaks."""

    def __init__(self):
        import queue

        self._jobs: "queue.Queue" = queue.Queue()
        self._empty = queue.Empty
        self._inflight = None
        self._thread = threading.Thread(
            target=self._run, name="light-prefetch", daemon=True)
        self._thread.start()

    def submit(self, fn, *args):
        import concurrent.futures as cf

        fut = cf.Future()
        self._jobs.put((fut, fn, args))
        return fut

    def _run(self) -> None:
        while True:
            item = self._jobs.get()
            if item is None:
                return
            fut, fn, args = item
            if not fut.set_running_or_notify_cancel():
                continue
            self._inflight = fut
            try:
                fut.set_result(fn(*args))
            except BaseException as e:
                fut.set_exception(e)
            finally:
                self._inflight = None

    def close(self, timeout: float = 5.0) -> None:
        try:
            while True:
                item = self._jobs.get_nowait()
                if item is not None:
                    item[0].cancel()
        except self._empty:
            pass
        self._jobs.put(None)
        self._thread.join(timeout=timeout)
        fut = self._inflight
        if fut is not None and fut.done():
            try:
                fut.exception(timeout=0)
            except BaseException:
                pass

    def __enter__(self) -> "_WindowPrefetcher":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class Client:
    def __init__(self, chain_id: str, trust_options: TrustOptions,
                 primary: Provider, witnesses: list[Provider] | None = None,
                 trusted_store: Store | None = None,
                 verification_mode: str = SKIPPING,
                 trust_level: Fraction = DEFAULT_TRUST_LEVEL,
                 max_clock_drift_ns: int = 10 * SECOND,
                 pruning_size: int = DEFAULT_PRUNING_SIZE,
                 # headers (commits) per RLC program in sequential sync
                 sequential_batch_size: int = 384,
                 # the verify pipeline's depth in sequential sync
                 # (crypto/dispatch.py): window w + 1 is fetched and
                 # collected while window w is on the card; 1 = serial
                 pipeline_depth: int = 2,
                 # devices the pipeline round-robins over
                 # (ops/sharding.mesh_device_list: 0 defers to
                 # COMETBFT_TPU_MESH_DEVICES, off unless set)
                 mesh_devices: int = 0,
                 now_fn=Timestamp.now,
                 device="cuda"):
        self.device = devmod.resolve(device)
        verifier.validate_trust_level(trust_level)
        trust_options.validate_basic()
        self.chain_id = chain_id
        self.trusting_period_ns = trust_options.period_ns
        self.trust_level = trust_level
        self.max_clock_drift_ns = max_clock_drift_ns
        self.verification_mode = verification_mode
        self.primary = primary
        self.witnesses = list(witnesses or [])
        self.store: Store = trusted_store or MemoryStore()
        self.pruning_size = pruning_size
        self.sequential_batch_size = max(1, sequential_batch_size)
        self.pipeline_depth = max(1, pipeline_depth)
        self.mesh_devices = mesh_devices
        self._now = now_fn
        self._initialize(trust_options)

    # -- initialization -------------------------------------------------------

    def _initialize(self, opts: TrustOptions) -> None:
        """Fetch the root block, check its hash and that it holds
        together, and store it."""
        from ..types.validation import verify_commit_light

        existing = self.store.light_block(opts.height)
        if existing is not None:
            if existing.hash() != opts.hash:
                raise LightClientError(
                    "trusted store block hash does not match trust options")
            return
        lb = self._from_primary(opts.height)
        if lb.hash() != opts.hash:
            raise LightClientError(
                f"primary's header hash {lb.hash().hex()} does not match "
                f"trust options' {opts.hash.hex()}")
        lb.validate_basic(self.chain_id, device=self.device)
        # +2/3 of that height's set must have signed it
        verify_commit_light(self.chain_id, lb.validator_set,
                            lb.signed_header.commit.block_id, lb.height,
                            lb.signed_header.commit, device=self.device)
        self.store.save_light_block(lb)

    # -- public API -------------------------------------------------------------

    def trusted_light_block(self, height: int) -> LightBlock | None:
        return self.store.light_block(height)

    def latest_trusted(self) -> LightBlock | None:
        return self.store.latest_light_block()

    def update(self, now: Timestamp | None = None) -> LightBlock | None:
        """Fetch and verify the primary's latest block."""
        now = now or self._now()
        latest = self._from_primary(0)
        trusted = self.store.latest_light_block()
        if trusted is not None and latest.height <= trusted.height:
            return None
        return self.verify_light_block_at_height(latest.height, now, latest)

    def verify_light_block_at_height(self, height: int,
                                     now: Timestamp | None = None,
                                     prefetched: LightBlock | None = None
                                     ) -> LightBlock:
        if height <= 0:
            raise ValueError("height must be positive")
        now = now or self._now()
        existing = self.store.light_block(height)
        if existing is not None:
            return existing
        latest = self.store.latest_light_block()
        if latest is None:
            raise LightClientError("no trusted state: initialize first")
        target = prefetched if prefetched is not None and \
            prefetched.height == height else self._from_primary(height)
        if target.height != height:
            raise LightClientError(
                f"provider returned height {target.height}, wanted {height}")
        self.verify_header(target, now)
        return target

    def verify_header(self, new_block: LightBlock, now: Timestamp) -> None:
        """Verify an already-fetched block forward from the closest
        trusted block below it; heights below the first trusted block go
        backwards by hashes."""
        latest = self.store.latest_light_block()
        if latest is None:
            raise LightClientError("no trusted state")
        if new_block.height < self.store.first_light_block().height:
            self._backwards(new_block, now)
            return
        anchor = self.store.light_block_before(new_block.height + 1)
        if anchor is not None and anchor.height == new_block.height:
            return
        new_block.validate_basic(self.chain_id, device=self.device)
        if self.verification_mode == SEQUENTIAL:
            trace = self._verify_sequential(anchor, new_block, now)
        else:
            trace = self._verify_skipping(self.primary, anchor, new_block,
                                          now)
        self._detect_divergence(trace, now)
        with trace_span("light", "store"):
            for lb in trace[1:]:
                self.store.save_light_block(lb)
            self.store.prune(self.pruning_size)

    # -- strategies -------------------------------------------------------------

    def _fetch_window(self, target: LightBlock, start: int,
                      end: int) -> list[LightBlock]:
        with trace_span("light", "fetch"):
            return [target if hh == target.height else
                    self._from_primary(hh) for hh in range(start, end + 1)]

    def _verify_sequential(self, trusted: LightBlock, target: LightBlock,
                           now: Timestamp) -> list[LightBlock]:
        """Headers are fetched and checked on the host one by one
        (chaining, set hashes, times), their commits' signatures
        collected into one DeferredSigBatch a window and verified on the
        card; a bad signature fails the whole window before anything is
        returned or stored.  With pipeline_depth >= 2 the overlapped path
        runs instead."""
        if self.pipeline_depth >= 2:
            return self._verify_sequential_pipelined(trusted, target, now)
        from ..types import validation

        trace = [trusted]
        verified = trusted
        h = trusted.height + 1
        bs = self.sequential_batch_size
        with _WindowPrefetcher() as ex:
            wend = min(h + bs - 1, target.height)
            pending = ex.submit(self._fetch_window, target, h, wend)
            while h <= target.height:
                window = pending.result()
                nxt = wend + 1
                if nxt <= target.height:
                    pending = ex.submit(self._fetch_window, target, nxt,
                                        min(nxt + bs - 1, target.height))
                batch = validation.DeferredSigBatch()
                with trace_span("light", "verify_dispatch"):
                    for interim in window:
                        verifier.verify_adjacent(
                            verified.signed_header, interim.signed_header,
                            interim.validator_set, self.trusting_period_ns,
                            now, self.max_clock_drift_ns, defer_to=batch,
                            device=self.device)
                        verified = interim
                with trace_span("light", "device"), \
                        sigcache.consumer("light"):
                    batch.verify(device=self.device)
                trace.extend(window)
                h = wend + 1
                wend = min(h + bs - 1, target.height)
        return trace

    def _verify_sequential_pipelined(self, trusted: LightBlock,
                                     target: LightBlock,
                                     now: Timestamp) -> list[LightBlock]:
        """The overlapped sequential sync: the next window's fetch and
        host checks run while the last window's signatures are on the
        card (VerifyPipeline, depth pipeline_depth).  Verdicts resolve in
        submission order; a window's headers join the trace only after
        its verdict; any failure raises before anything is stored."""
        from collections import deque

        from ..crypto.dispatch import VerifyPipeline
        from ..ops import sharding
        from ..types import validation

        trace = [trusted]
        verified = trusted
        h = trusted.height + 1
        bs = self.sequential_batch_size
        inflight: deque = deque()
        devices = sharding.mesh_device_list(self.mesh_devices or None)
        depth = self.pipeline_depth if devices is None else \
            max(self.pipeline_depth, 2 * len(devices))
        with _WindowPrefetcher() as ex, \
                VerifyPipeline(depth=depth, name="light-pipeline",
                               devices=devices if devices is not None
                               else (), device=self.device) as pipe:
            wend = min(h + bs - 1, target.height)
            pending = ex.submit(self._fetch_window, target, h, wend) \
                if h <= target.height else None
            while h <= target.height or inflight:
                if h <= target.height and len(inflight) < depth:
                    window = pending.result()
                    nxt = wend + 1
                    if nxt <= target.height:
                        pending = ex.submit(
                            self._fetch_window, target, nxt,
                            min(nxt + bs - 1, target.height))
                    batch = validation.DeferredSigBatch()
                    with trace_span("light", "verify_dispatch",
                                    inflight=len(inflight)), \
                            trace_span("light", "collect"):
                        for interim in window:
                            verifier.verify_adjacent(
                                verified.signed_header,
                                interim.signed_header,
                                interim.validator_set,
                                self.trusting_period_ns,
                                now, self.max_clock_drift_ns,
                                defer_to=batch, device=self.device)
                            verified = interim
                    inflight.append(
                        (window,
                         batch.verify_async(pipe, subsystem="light",
                                            lane=SCHED_LANE)))
                    h = wend + 1
                    wend = min(h + bs - 1, target.height)
                else:
                    window, verdict = inflight.popleft()
                    verdict.wait()
                    trace.extend(window)
        return trace

    def _verify_skipping(self, source: Provider, trusted: LightBlock,
                         target: LightBlock, now: Timestamp
                         ) -> list[LightBlock]:
        """Bisection, keeping the blocks it fetched (client.go
        verifySkipping)."""
        block_cache = [target]
        depth = 0
        verified = trusted
        trace = [trusted]
        while True:
            try:
                verifier.verify_light_block(
                    verified, block_cache[depth], self.trusting_period_ns,
                    now, self.max_clock_drift_ns, self.trust_level,
                    device=self.device)
            except ErrNewValSetCantBeTrusted:
                if depth == len(block_cache) - 1:
                    pivot = verified.height + (
                        block_cache[depth].height - verified.height
                    ) * _SKIP_NUM // _SKIP_DEN
                    try:
                        interim = source.light_block(pivot)
                    except (ErrLightBlockNotFound, ErrNoResponse,
                            ErrHeightTooHigh) as pe:
                        raise LightClientError(
                            f"cannot get pivot block {pivot}: {pe}") from pe
                    block_cache.append(interim)
                depth += 1
                continue
            if depth == 0:
                return trace + [target] if trace[-1] is not target else trace
            verified = block_cache[depth]
            block_cache = block_cache[:depth]
            depth = 0
            trace.append(verified)

    def _backwards(self, target: LightBlock, now: Timestamp) -> None:
        """Hash-chain down from the first trusted block.  Interim headers
        are not stored: only the target, once the whole chain checks."""
        target.validate_basic(self.chain_id, device=self.device)
        first = self.store.first_light_block()
        verified_header = first.signed_header.header
        while verified_header.height > target.height:
            h = verified_header.height - 1
            interim = target if h == target.height else self._from_primary(h)
            verifier.verify_backwards(interim.signed_header.header,
                                      verified_header, device=self.device)
            verified_header = interim.signed_header.header
        self.store.save_light_block(target)

    # -- witnesses --------------------------------------------------------------

    def _detect_divergence(self, trace: list[LightBlock],
                           now: Timestamp) -> None:
        """Compare the newly verified header with every witness's; a
        witness with a conflicting header it can back with a verified
        chain is a light-client attack (CometBFT light/detector.go)."""
        if not self.witnesses:
            return
        target = trace[-1]
        for w in list(self.witnesses):
            try:
                other = w.light_block(target.height)
            except ProviderError:
                continue
            if other.hash() != target.hash():
                evidence = self._examine_divergence(w, trace, other, now)
                if evidence is None:
                    # the witness could not back its header: it is the
                    # faulty one.  Drop it; with none left, fail closed,
                    # as a forking primary would otherwise go unnoticed
                    self.witnesses.remove(w)
                    if not self.witnesses:
                        raise LightClientError(
                            "no witnesses remain after dropping faulty "
                            "ones; cannot cross-verify the primary")
                    continue
                raise ErrLightClientAttack(evidence)

    def _examine_divergence(self, witness: Provider,
                            trace: list[LightBlock],
                            conflicting: LightBlock, now: Timestamp):
        """Find the last block of the verified trace that the witness
        agrees with (the common block), verify the witness's own chain
        from there to its conflicting header, and if it verifies, build
        the evidence of both sides, send each to the other side's
        provider, and return the evidence against the primary."""
        from ..types.evidence import (LightClientAttackEvidence,
                                      get_byzantine_validators)

        common = trace[0]
        for tb in trace[:-1]:
            try:
                wb = witness.light_block(tb.height)
            except ProviderError:
                break
            if wb.hash() != tb.hash():
                break
            common = tb
        try:
            self._verify_skipping(witness, common, conflicting, now)
        except (LightClientError, ProviderError):
            return None

        target = trace[-1]
        ev_against_primary = LightClientAttackEvidence(
            conflicting_block=target,
            common_height=common.height,
            byzantine_validators=get_byzantine_validators(
                common.validator_set, conflicting.signed_header, target),
            total_voting_power=common.validator_set.total_voting_power(),
            timestamp=common.signed_header.header.time)
        ev_against_witness = LightClientAttackEvidence(
            conflicting_block=conflicting,
            common_height=common.height,
            byzantine_validators=get_byzantine_validators(
                common.validator_set, target.signed_header, conflicting),
            total_voting_power=common.validator_set.total_voting_power(),
            timestamp=common.signed_header.header.time)
        # a failed report does not hide the attack
        for provider, ev_item in ((witness, ev_against_primary),
                                  (self.primary, ev_against_witness)):
            try:
                provider.report_evidence(ev_item)
            except Exception:
                pass
        return ev_against_primary

    # -- providers --------------------------------------------------------------

    def _from_primary(self, height: int) -> LightBlock:
        try:
            return self.primary.light_block(height)
        except ProviderError:
            # failover: the first witness that answers becomes the
            # primary (client.go findNewPrimary)
            for i, w in enumerate(self.witnesses):
                try:
                    lb = w.light_block(height)
                except ProviderError:
                    continue
                self.witnesses.pop(i)
                self.witnesses.append(self.primary)
                self.primary = w
                return lb
            raise
