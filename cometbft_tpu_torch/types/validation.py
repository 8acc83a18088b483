"""Commit verification — the port's main path (the counterpart of
`cometbft_tpu.types.validation`).

verify_commit / verify_commit_light / verify_commit_light_trusting keep
CometBFT's ignore/count/threshold semantics (types/validation.go) and
the JAX package's error classes and messages byte for byte, with the
batch routed to the port's BatchVerifier for the set's key type, or to
MixedBatchVerifier for a mixed-key set, on an explicit device.  Every
entry point takes `device=` (default "cuda") and resolves it first:
without a card it raises unless the caller passes device="cpu".

The batch seams consult the signature-verdict cache (crypto/sigcache)
first, as the JAX package does: only misses reach a verifier, and a
cached negative raises the same error before any dispatch.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..crypto import batch as crypto_batch
from ..crypto import sigcache
from ..ops import device as devmod
from .block import BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT

BATCH_VERIFY_THRESHOLD = 2


@dataclass(frozen=True)
class Fraction:
    numerator: int
    denominator: int


DEFAULT_TRUST_LEVEL = Fraction(1, 3)


class CommitVerificationError(Exception):
    pass


class ErrNotEnoughVotingPowerSigned(CommitVerificationError):
    def __init__(self, got: int, needed: int):
        super().__init__(
            f"invalid commit -- insufficient voting power: got {got}, "
            f"needed more than {needed}")
        self.got = got
        self.needed = needed


class ErrInvalidSignature(CommitVerificationError):
    pass


def _should_batch_verify(vals, commit) -> bool:
    if len(commit.signatures) < BATCH_VERIFY_THRESHOLD:
        return False
    if vals.all_keys_have_same_type():
        proposer = vals.get_proposer()
        return proposer is not None and proposer.pub_key is not None and \
            crypto_batch.supports_batch_verifier(proposer.pub_key.type())
    # mixed key types: MixedBatchVerifier handles them (CometBFT refuses)
    return True


class DeferredSigBatch:
    """Cross-commit signature batching: several commit verifications
    collect their signature checks here (structure and voting-power
    tallies still run per commit at collect time), then ONE device batch
    verifies them all — the blocksync window and light-client sync
    shape.  pack_rlc's per-pubkey aggregation makes the repeated
    validator set nearly free."""

    # below this many signatures the host loop wins over a device batch;
    # never below the single-commit threshold
    DEVICE_THRESHOLD = max(
        crypto_batch.DEVICE_THRESHOLD,
        int(os.environ.get("COMETBFT_TPU_DEFERRED_THRESHOLD", "128")))

    def __init__(self):
        # (label, context, pubkey, sign_bytes, sig); context is an
        # opaque caller value (e.g. a height) surfaced as .failed_ctx on
        # the raised error
        self._entries: list = []

    def count(self) -> int:
        return len(self._entries)

    def _extend(self, label: str, ctx, entries) -> None:
        for _, val, sign_bytes, sig in entries:
            self._entries.append((label, ctx, val.pub_key, sign_bytes,
                                  sig))

    @staticmethod
    def _fail(label, ctx, sig):
        err = ErrInvalidSignature(
            f"wrong signature in {label}: {sig.hex()}")
        err.failed_ctx = ctx
        return err

    def verify(self, device="cuda") -> None:
        """Raises ErrInvalidSignature naming the first failing commit
        (with .failed_ctx carrying that commit's context value)."""
        dev = devmod.resolve(device)
        if not self._entries:
            return
        self._entries, entries = [], self._entries
        # verdict-cache partition: triples the process already proved
        # skip the dispatch; a cached negative raises the error the
        # uncached path would, at once
        cached, miss_idx = sigcache.partition(
            [(pub, sign_bytes, sig)
             for _, _, pub, sign_bytes, sig in entries])
        for (label, ctx, _, _, sig), v in zip(entries, cached):
            if v is False:
                raise self._fail(label, ctx, sig)
        entries = [entries[i] for i in miss_idx]
        if not entries:
            return
        if len(entries) < self.DEVICE_THRESHOLD:
            for label, ctx, pub, sign_bytes, sig in entries:
                if not crypto_batch.safe_verify(pub, sign_bytes, sig):
                    raise self._fail(label, ctx, sig)
            return
        bv = crypto_batch.MixedBatchVerifier(device=dev)
        for _, _, pub, sign_bytes, sig in entries:
            bv.add(pub, sign_bytes, sig)
        ok, verdicts = bv.verify()
        if ok:
            return
        for (label, ctx, _, _, sig), valid in zip(entries, verdicts):
            if not valid:
                raise self._fail(label, ctx, sig)
        raise CommitVerificationError(
            "BUG: deferred batch failed with no invalid signatures")

    def verify_async(self, pipeline, subsystem: str = "pipeline",
                     lane: str | None = None):
        """Submit the collected entries through a VerifyPipeline
        (crypto/dispatch.py), on the pipeline's device, instead of
        verifying inline; returns a waiter whose .wait() has exactly
        verify()'s semantics (raises ErrInvalidSignature naming the
        first failing commit, with .failed_ctx) once the window's
        verdicts resolve.  The caller keeps collecting the next window
        while this one is staged or on the device.  `lane` puts the
        window under another QoS lane (crypto/sched.py) without
        changing `subsystem`'s trace and ledger attribution."""
        self._entries, entries = [], self._entries
        if not entries:
            return _DeferredVerdict(entries, None)
        handle = pipeline.submit(
            [(pub, sign_bytes, sig)
             for _, _, pub, sign_bytes, sig in entries],
            subsystem=subsystem, ctx=entries[0][1],
            device_threshold=self.DEVICE_THRESHOLD, lane=lane)
        return _DeferredVerdict(entries, handle)


class _DeferredVerdict:
    """An in-flight window's verdict: .wait() keeps
    DeferredSigBatch.verify()'s raise contract."""

    __slots__ = ("_entries", "handle")

    def __init__(self, entries, handle):
        self._entries = entries
        self.handle = handle

    def done(self) -> bool:
        return self.handle is None or self.handle.done()

    def wait(self, timeout: float | None = None) -> None:
        if self.handle is None:
            return
        ok, verdicts = self.handle.result(timeout)
        if ok:
            return
        for (label, ctx, _, _, sig), valid in zip(self._entries,
                                                  verdicts):
            if not valid:
                raise DeferredSigBatch._fail(label, ctx, sig)
        raise CommitVerificationError(
            "BUG: deferred window failed with no invalid signatures")

    def failed_contexts(self, timeout: float | None = None) -> set:
        """The set of ctx values (heights, for commit collection) with
        at least one invalid signature, instead of the first failure's
        raise; empty when the whole window verified."""
        if self.handle is None:
            return set()
        ok, verdicts = self.handle.result(timeout)
        if ok:
            return set()
        return {ctx for (_, ctx, _, _, _), valid
                in zip(self._entries, verdicts) if not valid}


def verify_commit(chain_id: str, vals, block_id, height: int, commit,
                  device="cuda") -> None:
    """+2/3 signed; checks ALL signatures (validation.go:28-56)."""
    dev = devmod.resolve(device)
    _verify_basic(vals, commit, height, block_id)
    needed = vals.total_voting_power() * 2 // 3
    ignore = lambda cs: cs.block_id_flag == BLOCK_ID_FLAG_ABSENT  # noqa: E731
    count = lambda cs: cs.block_id_flag == BLOCK_ID_FLAG_COMMIT  # noqa: E731
    _verify(chain_id, vals, commit, needed, ignore, count, dev,
            count_all=True, lookup_by_index=True)


def verify_commit_light(chain_id: str, vals, block_id, height: int,
                        commit, defer_to=None, device="cuda") -> None:
    """+2/3 signed; stops as soon as the tally crosses (validation.go:63).
    With defer_to (a DeferredSigBatch), signature checks are collected
    instead of verified; the caller runs defer_to.verify() later."""
    dev = devmod.resolve(device)
    _verify_basic(vals, commit, height, block_id)
    needed = vals.total_voting_power() * 2 // 3
    ignore = lambda cs: cs.block_id_flag != BLOCK_ID_FLAG_COMMIT  # noqa: E731
    count = lambda cs: True  # noqa: E731
    _verify(chain_id, vals, commit, needed, ignore, count, dev,
            count_all=False, lookup_by_index=True, defer_to=defer_to,
            defer_label=f"commit at height {height}", defer_ctx=height)


def verify_commit_light_trusting(chain_id: str, vals, commit,
                                 trust_level: Fraction,
                                 device="cuda") -> None:
    """trust_level of the (possibly different) valset signed
    (validation.go:129-204); lookup by address, early exit."""
    dev = devmod.resolve(device)
    if vals is None:
        raise CommitVerificationError("nil validator set")
    if commit is None:
        raise CommitVerificationError("nil commit")
    if trust_level.denominator == 0:
        raise CommitVerificationError("trustLevel has zero Denominator")
    total = vals.total_voting_power()
    if total * trust_level.numerator > (1 << 63) - 1:
        raise CommitVerificationError("int64 overflow in voting power")
    needed = total * trust_level.numerator // trust_level.denominator
    ignore = lambda cs: cs.block_id_flag != BLOCK_ID_FLAG_COMMIT  # noqa: E731
    count = lambda cs: True  # noqa: E731
    _verify(chain_id, vals, commit, needed, ignore, count, dev,
            count_all=False, lookup_by_index=False)


def _verify_basic(vals, commit, height, block_id):
    if vals is None:
        raise CommitVerificationError("nil validator set")
    if commit is None:
        raise CommitVerificationError("nil commit")
    if vals.size() != len(commit.signatures):
        raise CommitVerificationError(
            f"invalid commit -- wrong set size: {vals.size()} vs "
            f"{len(commit.signatures)}")
    if height != commit.height:
        raise CommitVerificationError(
            f"invalid commit -- wrong height: {height} vs {commit.height}")
    if block_id != commit.block_id:
        raise CommitVerificationError(
            f"invalid commit -- wrong block ID: want {block_id}, "
            f"got {commit.block_id}")


def _verify(chain_id, vals, commit, needed, ignore, count, device,
            count_all, lookup_by_index, defer_to=None, defer_label="",
            defer_ctx=None):
    """Collect the non-ignored signatures (validators by index or
    address), tally counted voting power with early exit, then verify —
    one device batch when batching is worthwhile, else one by one
    (validation.go:220-408)."""
    use_batch = _should_batch_verify(vals, commit)

    entries = []          # (commit_idx, validator, sign_bytes, signature)
    seen: dict[int, int] = {}
    tallied = 0
    sign_bytes_all = commit.vote_sign_bytes_all(chain_id)

    for idx, cs in enumerate(commit.signatures):
        if ignore(cs):
            continue
        if lookup_by_index:
            val = vals.validators[idx]
        else:
            val_idx, val = vals.get_by_address(cs.validator_address)
            if val is None:
                continue
            if val_idx in seen:
                raise CommitVerificationError(
                    f"double vote from {val.address.hex()} "
                    f"({seen[val_idx]} and {idx})")
            seen[val_idx] = idx
        if val.pub_key is None:
            raise CommitVerificationError(
                f"validator {val.address.hex()} has nil pubkey at "
                f"index {idx}")
        if not use_batch:
            cs.validate_basic()
        entries.append((idx, val, sign_bytes_all[idx], cs.signature))
        if count(cs):
            tallied += val.voting_power
        if not count_all and tallied > needed:
            break

    if tallied <= needed:
        raise ErrNotEnoughVotingPowerSigned(tallied, needed)

    if not entries:
        raise CommitVerificationError("BUG: no signatures to verify")

    if defer_to is not None:
        defer_to._extend(defer_label, defer_ctx, entries)
        return

    if use_batch:
        # verdict-cache partition: only misses reach a verifier; a
        # cached negative raises at once with the uncached path's
        # message (on a hot cache every entry is cached, so the first
        # False in entry order is the index the uncached scan names)
        cached, miss_idx = sigcache.partition(
            [(val.pub_key, sign_bytes, sig)
             for _, val, sign_bytes, sig in entries])
        for (idx, _, _, sig), v in zip(entries, cached):
            if v is False:
                raise ErrInvalidSignature(
                    f"wrong signature (#{idx}): {sig.hex()}")
        misses = [entries[i] for i in miss_idx]
        if not misses:
            return
        bv = crypto_batch.MixedBatchVerifier(device=device) \
            if not vals.all_keys_have_same_type() \
            else crypto_batch.create_batch_verifier(
                vals.get_proposer().pub_key.type(), n_hint=len(misses),
                device=device)
        for _, val, sign_bytes, sig in misses:
            bv.add(val.pub_key, sign_bytes, sig)
        ok, verdicts = bv.verify()
        if ok:
            return
        for (idx, _, _, sig), valid in zip(misses, verdicts):
            if not valid:
                raise ErrInvalidSignature(
                    f"wrong signature (#{idx}): {sig.hex()}")
        raise CommitVerificationError(
            "BUG: batch verification failed with no invalid signatures")

    for idx, val, sign_bytes, sig in entries:
        if not crypto_batch.safe_verify(val.pub_key, sign_bytes, sig):
            raise ErrInvalidSignature(
                f"wrong signature (#{idx}): {sig.hex()}")
