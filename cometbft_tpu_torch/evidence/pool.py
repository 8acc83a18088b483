"""Evidence pool (the port's copy of `cometbft_tpu.evidence.pool`;
CometBFT internal/evidence/pool.go).

Pending evidence persists in a KV store keyed by (height, hash) so it
survives restarts; committed evidence is marked and pruned once
expired. Consensus reports conflicting votes here
(ReportConflictingVotes) and the proposer drains pending_evidence into
blocks.

`EvidencePool(device=)` (default "cuda") is the device of every
light-client attack's commit check (evidence/verify.py); without a card
it raises unless given device="cpu".
"""

from __future__ import annotations

from ..libs import lockrank
from ..types.evidence import (
    DuplicateVoteEvidence, evidence_from_proto_wrapped,
    evidence_to_proto_wrapped,
)
from ..types.timestamp import Timestamp
from .verify import EvidenceVerificationError, verify_evidence

_PREFIX_PENDING = b"\x00"
_PREFIX_COMMITTED = b"\x01"


def _key(prefix: bytes, height: int, ev_hash: bytes) -> bytes:
    return prefix + height.to_bytes(8, "big") + ev_hash


class EvidenceError(Exception):
    pass


class ErrInvalidEvidence(EvidenceError):
    pass


class EvidencePool:
    """pool.go:102 Pool."""

    def __init__(self, db, state_store, block_store, device="cuda"):
        from ..ops import device as devmod

        self.device = devmod.resolve(device)
        self.db = db
        self.state_store = state_store
        self.block_store = block_store
        self._mtx = lockrank.RankedRLock("evidence.pool")
        self.state = state_store.load()
        # votes reported by consensus before their height is committed
        self._consensus_buffer: list = []
        self._pending_bytes = 0
        self._on_new_evidence = None  # reactor hook

    def set_event_callback(self, cb) -> None:
        self._on_new_evidence = cb

    # -- adding ------------------------------------------------------------
    def add_evidence(self, ev) -> None:
        """pool.go:190: verify then persist + broadcast."""
        with self._mtx:
            if self._is_pending(ev) or self._is_committed(ev):
                return
            verify_evidence(ev, self.state, self.state_store,
                            self.block_store, device=self.device)
            self._add_pending(ev)
        if self._on_new_evidence is not None:
            self._on_new_evidence(ev)

    def report_conflicting_votes(self, vote_a, vote_b) -> None:
        """From consensus (pool.go:235): buffered until the next block
        gives us the deterministic evidence time."""
        with self._mtx:
            self._consensus_buffer.append((vote_a, vote_b))

    def check_evidence(self, evidence: list) -> None:
        """Validate a proposed block's evidence list (pool.go:248)."""
        seen = set()
        for ev in evidence:
            h = ev.hash()
            if h in seen:
                raise ErrInvalidEvidence("duplicate evidence in block")
            seen.add(h)
            with self._mtx:
                if self._is_committed(ev):
                    raise ErrInvalidEvidence("evidence already committed")
                if not self._is_pending(ev):
                    verify_evidence(ev, self.state, self.state_store,
                                    self.block_store, device=self.device)
                    self._add_pending(ev)

    # -- consuming ---------------------------------------------------------
    def pending_evidence(self, max_bytes: int) -> tuple[list, int]:
        """pool.go PendingEvidence: (list, byte size)."""
        out, size = [], 0
        with self._mtx:
            for _, raw in self.db.iterate(_PREFIX_PENDING,
                                          _PREFIX_COMMITTED):
                ev = evidence_from_proto_wrapped(raw)
                ev_size = len(ev.bytes_())
                if max_bytes >= 0 and size + ev_size > max_bytes:
                    break
                out.append(ev)
                size += ev_size
        return out, size

    def update(self, state, evidence: list) -> None:
        """After a block commit (pool.go:110 Update): mark committed,
        prune expired, convert buffered conflicting votes."""
        with self._mtx:
            if state.last_block_height <= self.state.last_block_height:
                raise EvidenceError(
                    "failed EvidencePool.update: new state has "
                    "non-increasing height")
            self.state = state
            for ev in evidence:
                self._mark_committed(ev)
            self._prune_expired()
            buffered, self._consensus_buffer = \
                self._consensus_buffer, []
        for vote_a, vote_b in buffered:
            try:
                self._process_conflicting_votes(vote_a, vote_b)
            except EvidenceVerificationError:
                continue

    def _process_conflicting_votes(self, vote_a, vote_b) -> None:
        val_set = self.state_store.load_validators(vote_a.height)
        block_meta = self.block_store.load_block_meta(vote_a.height)
        if block_meta is None:
            return
        ev = DuplicateVoteEvidence.new(
            vote_a, vote_b, block_meta.header.time, val_set)
        self.add_evidence(ev)

    # -- internals ---------------------------------------------------------
    def _add_pending(self, ev) -> None:
        self.db.set(_key(_PREFIX_PENDING, ev.height(), ev.hash()),
                    evidence_to_proto_wrapped(ev))

    def _is_pending(self, ev) -> bool:
        return self.db.get(
            _key(_PREFIX_PENDING, ev.height(), ev.hash())) is not None

    def _is_committed(self, ev) -> bool:
        return self.db.get(
            _key(_PREFIX_COMMITTED, ev.height(), ev.hash())) is not None

    def _mark_committed(self, ev) -> None:
        # marker value = evidence time, so expiry can apply both the
        # height AND duration rules without the full evidence body
        self.db.set(_key(_PREFIX_COMMITTED, ev.height(), ev.hash()),
                    ev.time().to_proto())
        self.db.delete(_key(_PREFIX_PENDING, ev.height(), ev.hash()))

    def _prune_expired(self) -> None:
        params = self.state.consensus_params.evidence
        height = self.state.last_block_height
        now = self.state.last_block_time
        drop = []
        for key, raw in self.db.iterate(_PREFIX_PENDING,
                                        _PREFIX_COMMITTED):
            ev = evidence_from_proto_wrapped(raw)
            if height - ev.height() > params.max_age_num_blocks and \
                    now.diff_ns(ev.time()) > params.max_age_duration_ns:
                drop.append(key)
        # committed markers expire under the same height+duration rule
        # (verify_evidence would reject a resubmission anyway), which
        # bounds DB growth
        cutoff = height - params.max_age_num_blocks
        if cutoff > 0:
            end = _key(_PREFIX_COMMITTED, cutoff, b"")
            for key, raw in self.db.iterate(_PREFIX_COMMITTED, end):
                try:
                    ev_time = Timestamp.from_proto(raw)
                except Exception:
                    drop.append(key)
                    continue
                if now.diff_ns(ev_time) > params.max_age_duration_ns:
                    drop.append(key)
        for key in drop:
            self.db.delete(key)
