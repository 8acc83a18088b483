"""Validator and ValidatorSet (the port's copy of
`cometbft_tpu.types.validator_set`; CometBFT types/validator.go,
validator_set.go).

Consensus-critical behaviour, as CometBFT has it:
- validators kept sorted by address ascending, so a commit's signature i
  belongs to validators[i];
- the proposer is the priority round-robin: rescale the priorities to a
  2 * total-power window, shift them by their average, add each voting
  power, pick the highest (ties to the lower address), subtract the
  total from it;
- ABCI updates: a change set is split into updates and removals, checked
  (duplicates, negative power, absent removals, total-power overflow),
  new validators start at -1.125 * the updated total, then updates and
  removals apply and the priorities are rescaled and re-centred;
- the constructor applies its list as a change set, then walks the
  priorities once;
- hash() is the Merkle root of the validators' SimpleValidator bytes, its
  leaves hashed on the card (crypto/merkle.py).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import merkle
from ..crypto.encoding import pubkey_from_proto, pubkey_to_proto
from ..libs import protowire as pw

MAX_INT64 = (1 << 63) - 1
MIN_INT64 = -(1 << 63)
MAX_TOTAL_VOTING_POWER = MAX_INT64 // 8
PRIORITY_WINDOW_SIZE_FACTOR = 2


def _clip(v: int) -> int:
    return max(MIN_INT64, min(MAX_INT64, v))


@dataclass
class Validator:
    pub_key: object
    voting_power: int
    proposer_priority: int = 0
    address: bytes = b""

    def __post_init__(self):
        if not self.address and self.pub_key is not None:
            self.address = self.pub_key.address()

    def copy(self) -> "Validator":
        return Validator(self.pub_key, self.voting_power,
                         self.proposer_priority, self.address)

    def bytes(self) -> bytes:
        """SimpleValidator proto: pub_key = 1 (always emitted), power = 2
        (CometBFT types/validator.go Bytes)."""
        return (pw.Writer()
                .message_field(1, pubkey_to_proto(self.pub_key))
                .int_field(2, self.voting_power).bytes())

    def compare_proposer_priority(self, other: "Validator") -> "Validator":
        """The higher priority wins; ties go to the lower address."""
        if other is None:
            return self
        if self.proposer_priority > other.proposer_priority:
            return self
        if self.proposer_priority < other.proposer_priority:
            return other
        if self.address < other.address:
            return self
        if self.address > other.address:
            return other
        raise ValueError("cannot compare identical validators")

    def validate_basic(self) -> None:
        if self.pub_key is None:
            raise ValueError("validator does not have a public key")
        if self.voting_power < 0:
            raise ValueError("validator has negative voting power")
        if len(self.address) != 20:
            raise ValueError("validator address is the wrong size")

    def to_proto(self) -> bytes:
        return (pw.Writer()
                .bytes_field(1, self.address)
                .message_field(2, pubkey_to_proto(self.pub_key))
                .int_field(3, self.voting_power)
                .int_field(4, self.proposer_priority).bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "Validator":
        r = pw.Reader(payload)
        addr, pk, power, prio = b"", None, 0, 0
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                addr = r.read_bytes()
            elif f == 2 and w == pw.BYTES:
                pk = pubkey_from_proto(r.read_bytes())
            elif f == 3 and w == pw.VARINT:
                power = r.read_int()
            elif f == 4 and w == pw.VARINT:
                prio = r.read_int()
            else:
                r.skip(w)
        return Validator(pk, power, prio, addr)


class ValidatorSet:
    def __init__(self, validators: list[Validator] | None = None):
        self.validators: list[Validator] = []
        self.proposer: Validator | None = None
        self._total_voting_power = 0
        self._addr_index: dict[bytes, int] | None = None
        if validators is not None:
            self._update_with_change_set(
                [v.copy() for v in validators], allow_deletes=False)
            if validators:
                self.increment_proposer_priority(1)

    @staticmethod
    def from_validated(validators: list[Validator],
                       proposer: Validator | None = None) -> "ValidatorSet":
        """Adopt an already-correct validator list as it is, priorities
        included: a set read from RPC or storage, where running the update
        rules again would change its priorities."""
        out = ValidatorSet()
        out.validators = list(validators)
        if validators:
            out._update_total_voting_power()
            out.proposer = proposer if proposer is not None \
                else out._find_proposer()
        return out

    # -- accessors ----------------------------------------------------------

    def is_nil_or_empty(self) -> bool:
        return not self.validators

    def size(self) -> int:
        return len(self.validators)

    def __len__(self) -> int:
        return len(self.validators)

    def copy(self) -> "ValidatorSet":
        out = ValidatorSet()
        out.validators = [v.copy() for v in self.validators]
        out.proposer = self.proposer
        out._total_voting_power = self._total_voting_power
        return out

    def _index(self) -> dict[bytes, int]:
        """Address -> index, dropped on membership changes."""
        if self._addr_index is None:
            self._addr_index = {v.address: i
                                for i, v in enumerate(self.validators)}
        return self._addr_index

    def has_address(self, address: bytes) -> bool:
        return address in self._index()

    def get_by_address(self, address: bytes):
        i = self._index().get(address, -1)
        if i < 0:
            return -1, None
        return i, self.validators[i]

    def get_by_index(self, index: int):
        if index < 0 or index >= len(self.validators):
            return None, None
        v = self.validators[index]
        return v.address, v

    def total_voting_power(self) -> int:
        if self._total_voting_power == 0:
            self._update_total_voting_power()
        return self._total_voting_power

    def _update_total_voting_power(self) -> None:
        total = 0
        for v in self.validators:
            total = _clip(total + v.voting_power)
            if total > MAX_TOTAL_VOTING_POWER:
                raise OverflowError(
                    f"total voting power exceeds {MAX_TOTAL_VOTING_POWER}")
        self._total_voting_power = total

    def all_keys_have_same_type(self) -> bool:
        types = {v.pub_key.type() if v.pub_key is not None else None
                 for v in self.validators}
        return len(types) <= 1

    # -- proposer rotation ----------------------------------------------------

    def get_proposer(self) -> Validator | None:
        if not self.validators:
            return None
        if self.proposer is None:
            self.proposer = self._find_proposer()
        return self.proposer.copy()

    def _find_proposer(self) -> Validator:
        proposer = None
        for v in self.validators:
            if proposer is None or v.address != proposer.address:
                proposer = v.compare_proposer_priority(proposer) \
                    if proposer else v
        return proposer

    def increment_proposer_priority(self, times: int) -> None:
        if self.is_nil_or_empty():
            raise ValueError("empty validator set")
        if times <= 0:
            raise ValueError("times must be positive")
        diff_max = PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        self.rescale_priorities(diff_max)
        self._shift_by_avg_proposer_priority()
        proposer = None
        for _ in range(times):
            proposer = self._increment_proposer_priority()
        self.proposer = proposer

    def _increment_proposer_priority(self) -> Validator:
        for v in self.validators:
            v.proposer_priority = _clip(
                v.proposer_priority + v.voting_power)
        mostest = None
        for v in self.validators:
            mostest = v.compare_proposer_priority(mostest) \
                if mostest else v
        mostest.proposer_priority = _clip(
            mostest.proposer_priority - self.total_voting_power())
        return mostest

    def rescale_priorities(self, diff_max: int) -> None:
        if self.is_nil_or_empty():
            raise ValueError("empty validator set")
        if diff_max <= 0:
            return
        diff = self._max_min_priority_diff()
        ratio = (diff + diff_max - 1) // diff_max
        if diff > diff_max:
            for v in self.validators:
                # Go's integer division truncates toward zero
                p = v.proposer_priority
                v.proposer_priority = -(-p // ratio) if p < 0 else p // ratio

    def _max_min_priority_diff(self) -> int:
        prios = [v.proposer_priority for v in self.validators]
        return abs(max(prios) - min(prios))

    def _compute_avg_proposer_priority(self) -> int:
        # big.Int.Div: Euclidean division, Python's // for a positive n
        total = sum(v.proposer_priority for v in self.validators)
        return total // len(self.validators)

    def _shift_by_avg_proposer_priority(self) -> None:
        avg = self._compute_avg_proposer_priority()
        for v in self.validators:
            v.proposer_priority = _clip(v.proposer_priority - avg)

    # -- hashing ----------------------------------------------------------------

    def hash(self, device="cuda") -> bytes:
        """Merkle root over the validators' bytes; the leaf hashes run
        on `device` in one K10 launch from
        crypto/hash.DEVICE_HASH_THRESHOLD validators on (hashlib below)."""
        return merkle.hash_from_byte_slices_device(
            [v.bytes() for v in self.validators], device=device)

    # -- updates (ABCI validator changes) -----------------------------------

    def update_with_change_set(self, changes: list[Validator]) -> None:
        self._update_with_change_set([v.copy() for v in changes],
                                     allow_deletes=True)

    def _update_with_change_set(self, changes: list[Validator],
                                allow_deletes: bool) -> None:
        if not changes:
            return
        updates, deletes = _process_changes(changes)
        if not allow_deletes and deletes:
            raise ValueError("cannot process validators with power 0")
        removed_power = _verify_removals(deletes, self)
        tvp_after = _verify_updates(updates, self, removed_power)
        _compute_new_priorities(updates, self, tvp_after)
        self._apply_updates(updates)
        self._apply_removals(deletes)
        self._total_voting_power = 0
        self._update_total_voting_power()
        if self.validators:
            self.rescale_priorities(
                PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power())
            self._shift_by_avg_proposer_priority()

    def _apply_updates(self, updates: list[Validator]) -> None:
        existing = sorted(self.validators, key=lambda v: v.address)
        merged: list[Validator] = []
        i = j = 0
        while i < len(existing) and j < len(updates):
            if existing[i].address < updates[j].address:
                merged.append(existing[i])
                i += 1
            else:
                merged.append(updates[j])
                if existing[i].address == updates[j].address:
                    i += 1
                j += 1
        merged.extend(existing[i:])
        merged.extend(updates[j:])
        self.validators = merged
        self._addr_index = None

    def _apply_removals(self, deletes: list[Validator]) -> None:
        if not deletes:
            return
        gone = {d.address for d in deletes}
        self.validators = [v for v in self.validators
                           if v.address not in gone]
        self._addr_index = None

    def validate_basic(self) -> None:
        """Every validator and the proposer must be valid; a missing
        proposer is an error."""
        if self.is_nil_or_empty():
            raise ValueError("validator set is nil or empty")
        for v in self.validators:
            v.validate_basic()
        if self.proposer is None:
            raise ValueError("proposer failed validate basic: nil validator")
        self.proposer.validate_basic()

    # -- commit verification on the card ------------------------------------

    def verify_commit(self, chain_id: str, block_id, height: int, commit,
                      device="cuda") -> None:
        from .validation import verify_commit
        verify_commit(chain_id, self, block_id, height, commit,
                      device=device)

    def verify_commit_light(self, chain_id: str, block_id, height: int,
                            commit, defer_to=None, device="cuda") -> None:
        from .validation import verify_commit_light
        verify_commit_light(chain_id, self, block_id, height, commit,
                            defer_to=defer_to, device=device)

    def verify_commit_light_trusting(self, chain_id: str, commit,
                                     trust_level, device="cuda") -> None:
        from .validation import verify_commit_light_trusting
        verify_commit_light_trusting(chain_id, self, commit, trust_level,
                                     device=device)

    def to_proto(self) -> bytes:
        """ValidatorSet proto (proto/cometbft/types/v1/validator.proto):
        validators = 1 repeated, proposer = 2, total_voting_power = 3."""
        w = pw.Writer()
        for v in self.validators:
            w.message_field(1, v.to_proto())
        if self.proposer is not None:
            w.message_field(2, self.proposer.to_proto())
        w.int_field(3, self.total_voting_power())
        return w.bytes()

    @staticmethod
    def from_proto(payload: bytes) -> "ValidatorSet":
        r = pw.Reader(payload)
        out = ValidatorSet()
        proposer = None
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                out.validators.append(Validator.from_proto(r.read_bytes()))
            elif f == 2 and w == pw.BYTES:
                proposer = Validator.from_proto(r.read_bytes())
            else:
                r.skip(w)
        out.proposer = proposer
        out._update_total_voting_power()
        return out


def _process_changes(changes: list[Validator]):
    """Split into updates and removals, sorted by address; reject
    duplicates and negative or oversized powers."""
    changes = sorted(changes, key=lambda v: v.address)
    updates, removals = [], []
    prev = None
    for c in changes:
        if prev is not None and c.address == prev:
            raise ValueError(f"duplicate entry {c.address.hex()}")
        if c.voting_power < 0:
            raise ValueError("voting power can't be negative")
        if c.voting_power > MAX_TOTAL_VOTING_POWER:
            raise ValueError("voting power too high")
        (removals if c.voting_power == 0 else updates).append(c)
        prev = c.address
    return updates, removals


def _verify_removals(deletes: list[Validator], vals: ValidatorSet) -> int:
    removed = 0
    for d in deletes:
        _, val = vals.get_by_address(d.address)
        if val is None:
            raise ValueError(
                f"removing non-existent validator {d.address.hex()}")
        removed += val.voting_power
    return removed


def _verify_updates(updates: list[Validator], vals: ValidatorSet,
                    removed_power: int) -> int:
    def delta(u: Validator) -> int:
        _, val = vals.get_by_address(u.address)
        return u.voting_power - val.voting_power if val else u.voting_power

    tvp_after_removals = vals.total_voting_power() - removed_power
    for u in sorted(updates, key=delta):
        tvp_after_removals += delta(u)
        if tvp_after_removals > MAX_TOTAL_VOTING_POWER:
            raise OverflowError("total voting power overflow")
    return tvp_after_removals + removed_power


def _compute_new_priorities(updates: list[Validator], vals: ValidatorSet,
                            updated_tvp: int) -> None:
    for u in updates:
        _, val = vals.get_by_address(u.address)
        if val is None:
            u.proposer_priority = -(updated_tvp + (updated_tvp >> 3))
        else:
            u.proposer_priority = val.proposer_priority
