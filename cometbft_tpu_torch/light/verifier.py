"""Pure light-client verification (the port's copy of
`cometbft_tpu.light.verifier`; CometBFT light/verifier.go).

verify_adjacent, verify_non_adjacent and verify_backwards keep CometBFT's
checks and order and the JAX package's error classes and messages; the
commit signatures are verified on the card (types/validation.py: one RLC
program a commit, K1-K4, or a DeferredSigBatch window across headers).
Every function that reaches a valset hash or a signature takes `device=`
(default "cuda") and raises without a card unless given device="cpu".
Durations are nanoseconds (ints).
"""

from __future__ import annotations

from ..crypto import sigcache
from ..ops import device as devmod
from ..types.timestamp import Timestamp
from ..types.validation import (
    ErrNotEnoughVotingPowerSigned, Fraction, verify_commit_light,
    verify_commit_light_trusting,
)
from .types import LightBlock, SignedHeader

DEFAULT_TRUST_LEVEL = Fraction(1, 3)

SECOND = 1_000_000_000
DEFAULT_MAX_CLOCK_DRIFT = 10 * SECOND


class LightClientError(Exception):
    pass


class ErrOldHeaderExpired(LightClientError):
    pass


class ErrInvalidHeader(LightClientError):
    pass


class ErrNewValSetCantBeTrusted(LightClientError):
    pass


class ErrHeaderHeightAdjacent(LightClientError):
    pass


class ErrHeaderHeightNotAdjacent(LightClientError):
    pass


class ErrInvalidTrustLevel(LightClientError):
    pass


def validate_trust_level(lvl: Fraction) -> None:
    """The trust level must lie in [1/3, 1]."""
    if (lvl.numerator * 3 < lvl.denominator
            or lvl.numerator > lvl.denominator
            or lvl.denominator == 0):
        raise ErrInvalidTrustLevel(f"trust level must be in [1/3, 1]: {lvl}")


def header_expired(h: SignedHeader, trusting_period_ns: int,
                   now: Timestamp) -> bool:
    expiration = h.header.time.add_ns(trusting_period_ns)
    return expiration <= now


def _verify_new_header_and_vals(untrusted: SignedHeader, untrusted_vals,
                                trusted: SignedHeader, now: Timestamp,
                                max_clock_drift_ns: int, device) -> None:
    try:
        untrusted.validate_basic(trusted.chain_id)
    except ValueError as e:
        raise ErrInvalidHeader(f"header validate basic: {e}") from e
    if untrusted.height <= trusted.height:
        raise ErrInvalidHeader(
            f"expected new header height {untrusted.height} > "
            f"{trusted.height}")
    if untrusted.header.time <= trusted.header.time:
        raise ErrInvalidHeader("non-monotonic header time")
    if untrusted.header.time >= now.add_ns(max_clock_drift_ns):
        raise ErrInvalidHeader("new header time exceeds max clock drift")
    if untrusted.header.validators_hash != untrusted_vals.hash(device=device):
        raise ErrInvalidHeader(
            f"validators hash mismatch at height {untrusted.height}")


def verify_adjacent(trusted: SignedHeader, untrusted: SignedHeader,
                    untrusted_vals, trusting_period_ns: int, now: Timestamp,
                    max_clock_drift_ns: int, defer_to=None,
                    device="cuda") -> None:
    """The header right after a trusted one: its set must be the one the
    trusted header named, and +2/3 of it must have signed.  defer_to (a
    validation.DeferredSigBatch) collects the commit's signature checks
    for one later window on the card; every structural check still runs
    now."""
    dev = devmod.resolve(device)
    if untrusted.height != trusted.height + 1:
        raise ErrHeaderHeightNotAdjacent()
    if header_expired(trusted, trusting_period_ns, now):
        raise ErrOldHeaderExpired()
    _verify_new_header_and_vals(untrusted, untrusted_vals, trusted, now,
                                max_clock_drift_ns, dev)
    if untrusted.header.validators_hash != trusted.header.next_validators_hash:
        raise ErrInvalidHeader(
            f"expected old header next validators "
            f"({trusted.header.next_validators_hash.hex()}) to match those "
            f"from new header ({untrusted.header.validators_hash.hex()})")
    try:
        with sigcache.consumer("light"):
            verify_commit_light(trusted.chain_id, untrusted_vals,
                                untrusted.commit.block_id,
                                untrusted.height, untrusted.commit,
                                defer_to=defer_to, device=dev)
    except Exception as e:
        raise ErrInvalidHeader(str(e)) from e


def verify_non_adjacent(trusted: SignedHeader, trusted_vals,
                        untrusted: SignedHeader, untrusted_vals,
                        trusting_period_ns: int, now: Timestamp,
                        max_clock_drift_ns: int,
                        trust_level: Fraction, device="cuda") -> None:
    """A header further on: trust_level of the trusted set, then +2/3 of
    the new set, must have signed.  The trusting check runs first, so a
    huge fake set cannot make the client verify it."""
    dev = devmod.resolve(device)
    if untrusted.height == trusted.height + 1:
        raise ErrHeaderHeightAdjacent()
    if header_expired(trusted, trusting_period_ns, now):
        raise ErrOldHeaderExpired()
    _verify_new_header_and_vals(untrusted, untrusted_vals, trusted, now,
                                max_clock_drift_ns, dev)
    try:
        with sigcache.consumer("light"):
            verify_commit_light_trusting(trusted.chain_id, trusted_vals,
                                         untrusted.commit, trust_level,
                                         device=dev)
    except ErrNotEnoughVotingPowerSigned as e:
        raise ErrNewValSetCantBeTrusted(str(e)) from e
    try:
        with sigcache.consumer("light"):
            verify_commit_light(trusted.chain_id, untrusted_vals,
                                untrusted.commit.block_id,
                                untrusted.height, untrusted.commit,
                                device=dev)
    except Exception as e:
        raise ErrInvalidHeader(str(e)) from e


def verify(trusted: SignedHeader, trusted_vals, untrusted: SignedHeader,
           untrusted_vals, trusting_period_ns: int, now: Timestamp,
           max_clock_drift_ns: int, trust_level: Fraction,
           device="cuda") -> None:
    """Adjacent or skipping, by height."""
    if untrusted.height != trusted.height + 1:
        verify_non_adjacent(trusted, trusted_vals, untrusted,
                            untrusted_vals, trusting_period_ns, now,
                            max_clock_drift_ns, trust_level, device=device)
    else:
        verify_adjacent(trusted, untrusted, untrusted_vals,
                        trusting_period_ns, now, max_clock_drift_ns,
                        device=device)


def verify_backwards(untrusted_header, trusted_header,
                     device="cuda") -> None:
    """Hash-chain one height backwards: no signature, no set hash; the
    device is resolved all the same, as at every entry point."""
    devmod.resolve(device)
    try:
        untrusted_header.validate_basic()
    except ValueError as e:
        raise ErrInvalidHeader(str(e)) from e
    if untrusted_header.chain_id != trusted_header.chain_id:
        raise ErrInvalidHeader("header belongs to another chain")
    if untrusted_header.time >= trusted_header.time:
        raise ErrInvalidHeader(
            "expected older header time to be before new header time")
    if untrusted_header.hash() != trusted_header.last_block_id.hash:
        raise ErrInvalidHeader(
            "older header hash does not match trusted header's last block")


def verify_light_block(trusted: LightBlock, untrusted: LightBlock,
                       trusting_period_ns: int, now: Timestamp,
                       max_clock_drift_ns: int,
                       trust_level: Fraction, device="cuda") -> None:
    verify(trusted.signed_header, trusted.validator_set,
           untrusted.signed_header, untrusted.validator_set,
           trusting_period_ns, now, max_clock_drift_ns, trust_level,
           device=device)
