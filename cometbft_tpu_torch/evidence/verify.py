"""Evidence verification (the port's copy of
`cometbft_tpu.evidence.verify`; CometBFT internal/evidence/verify.go).

Checks that submitted evidence is (a) not expired under the consensus
params' age limits, (b) internally consistent, and (c) signed by the
accused validators.  A duplicate vote's two signatures verify through
crypto/batch.safe_verify on the host, under the "evidence" consumer, so
a vote that consensus already verified is a verdict-cache hit.  A
light-client attack's conflicting commit verifies through
types/validation.verify_commit_light_trusting on `device` (default
"cuda": the RLC program on K1-K4 at DEVICE_THRESHOLD signatures and
more); without a card it raises unless given device="cpu".
"""

from __future__ import annotations

from ..crypto import sigcache
from ..crypto.batch import safe_verify
from ..types.evidence import (
    DuplicateVoteEvidence, LightClientAttackEvidence,
)


class EvidenceVerificationError(Exception):
    pass


def verify_evidence(ev, state, state_store, block_store,
                    device="cuda") -> None:
    """verify.go:31 verify()."""
    height = state.last_block_height
    ev_params = state.consensus_params.evidence

    age_num_blocks = height - ev.height()
    if age_num_blocks > ev_params.max_age_num_blocks:
        # expired by blocks; also expired by time?
        age_ns = state.last_block_time.diff_ns(ev.time())
        if age_ns > ev_params.max_age_duration_ns:
            raise EvidenceVerificationError(
                f"evidence from height {ev.height()} is too old: "
                f"{age_num_blocks} blocks, {age_ns / 1e9:.0f}s")

    if isinstance(ev, DuplicateVoteEvidence):
        header = _load_header(block_store, ev.height())
        if header is not None and \
                header.time.diff_ns(ev.time()) != 0:
            raise EvidenceVerificationError(
                "duplicate-vote evidence time does not match block time")
        val_set = state_store.load_validators(ev.height())
        verify_duplicate_vote(ev, state.chain_id, val_set)
    elif isinstance(ev, LightClientAttackEvidence):
        verify_light_client_attack(ev, state, state_store, block_store,
                                   device=device)
    else:
        raise EvidenceVerificationError(
            f"unknown evidence type {type(ev)}")


def verify_duplicate_vote(ev: DuplicateVoteEvidence, chain_id: str,
                          val_set) -> None:
    """verify.go:186 VerifyDuplicateVote."""
    va, vb = ev.vote_a, ev.vote_b
    _, val = val_set.get_by_address(va.validator_address)
    if val is None:
        raise EvidenceVerificationError(
            f"address {va.validator_address.hex()} was not a validator "
            f"at height {ev.height()}")

    if va.height != vb.height or va.round != vb.round or \
            va.type != vb.type:
        raise EvidenceVerificationError(
            "votes are not for the same height/round/type")
    if va.block_id == vb.block_id:
        raise EvidenceVerificationError(
            "votes are for the same block id — not equivocation")
    if va.validator_address != vb.validator_address:
        raise EvidenceVerificationError(
            "votes are from different validators")
    if va.block_id.key() > vb.block_id.key():
        raise EvidenceVerificationError(
            "votes not sorted by block id (vote_a must be the lesser)")

    if ev.validator_power != val.voting_power:
        raise EvidenceVerificationError(
            f"evidence validator power {ev.validator_power} != actual "
            f"{val.voting_power}")
    if ev.total_voting_power != val_set.total_voting_power():
        raise EvidenceVerificationError(
            f"evidence total power {ev.total_voting_power} != actual "
            f"{val_set.total_voting_power()}")

    # safe_verify rides the process-wide verdict cache: the accused
    # validator's CANONICAL vote was usually verified live by
    # consensus, so one of the pair is typically a hit
    pub_key = val.pub_key
    with sigcache.consumer("evidence"):
        if not safe_verify(pub_key, va.sign_bytes(chain_id),
                           va.signature):
            raise EvidenceVerificationError("invalid signature on vote A")
        if not safe_verify(pub_key, vb.sign_bytes(chain_id),
                           vb.signature):
            raise EvidenceVerificationError("invalid signature on vote B")


def verify_light_client_attack(ev: LightClientAttackEvidence, state,
                               state_store, block_store=None,
                               device="cuda") -> None:
    """verify.go VerifyLightClientAttack.

    The conflicting block's commit must carry 1/3+ of the common-height
    validators' signatures (trusting batch path, on `device`), its
    header must actually DIFFER from our stored header at that height,
    and every accused byzantine validator must have signed the
    conflicting commit: otherwise fabricated evidence could frame honest
    validators."""
    from ..types.block import BLOCK_ID_FLAG_ABSENT
    from ..types.validation import Fraction, verify_commit_light_trusting

    common_vals = state_store.load_validators(ev.common_height)
    cb = ev.conflicting_block
    if cb is None or getattr(cb, "signed_header", None) is None:
        raise EvidenceVerificationError(
            "light-client attack evidence missing conflicting block")
    sh = cb.signed_header
    with sigcache.consumer("evidence"):
        verify_commit_light_trusting(
            state.chain_id, common_vals, sh.commit, Fraction(1, 3),
            device=device)
    if ev.total_voting_power != common_vals.total_voting_power():
        raise EvidenceVerificationError(
            "evidence total power does not match common validator set")

    # the conflicting header must conflict with OUR chain
    if block_store is not None:
        trusted = block_store.load_block_meta(sh.header.height)
        if trusted is not None and \
                trusted.block_id.hash == sh.header.hash():
            raise EvidenceVerificationError(
                "conflicting block matches the canonical chain — "
                "no divergence to report")

    # accused validators must exist at the common height AND have
    # signed the conflicting commit (verify.go:103-120)
    signers = {
        s.validator_address
        for s in sh.commit.signatures
        if s.block_id_flag != BLOCK_ID_FLAG_ABSENT}
    for val in ev.byzantine_validators:
        _, member = common_vals.get_by_address(val.address)
        if member is None:
            raise EvidenceVerificationError(
                f"accused validator {val.address.hex()} not in the "
                f"common-height validator set")
        if val.address not in signers:
            raise EvidenceVerificationError(
                f"accused validator {val.address.hex()} did not sign "
                f"the conflicting commit")


def _load_header(block_store, height: int):
    if block_store is None:
        return None
    meta = block_store.load_block_meta(height)
    return meta.header if meta is not None else None
