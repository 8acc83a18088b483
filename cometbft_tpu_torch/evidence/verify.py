"""Duplicate-vote evidence verification (the port's copy of
`cometbft_tpu.evidence.verify.verify_duplicate_vote`; CometBFT
internal/evidence/verify.go).

Checks that the evidence is internally consistent and signed by the
accused validator.  Both signatures verify through
crypto/batch.safe_verify under the "evidence" consumer, so a vote that
consensus already verified is a verdict-cache hit.  The age checks
against stored state and light-client attacks wait for the port's state
and light types.
"""

from __future__ import annotations

from ..crypto import sigcache
from ..crypto.batch import safe_verify
from ..types.evidence import DuplicateVoteEvidence


class EvidenceVerificationError(Exception):
    pass


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
