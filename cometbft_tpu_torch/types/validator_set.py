"""Validator and the read side of ValidatorSet (the port's copy of what
commit verification reads from `cometbft_tpu.types.validator_set`).

Validators are kept sorted by address ascending, as CometBFT keeps them,
so a commit's signature i belongs to validators[i] in both packages.
ValidatorSet.hash() is the Merkle root of the validators' SimpleValidator
bytes, its leaves hashed on the card (crypto/merkle.py).
Priority rotation and ABCI updates are not ported: a fresh set's first
proposer is the validator of highest voting power, ties to the lower
address — what one round of CometBFT's priority walk picks from equal
starting priorities.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import encoding, merkle
from ..libs import protowire as pw

MAX_INT64 = (1 << 63) - 1
MAX_TOTAL_VOTING_POWER = MAX_INT64 // 8


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
                .message_field(1, encoding.pubkey_to_proto(self.pub_key))
                .int_field(2, self.voting_power).bytes())


class ValidatorSet:
    def __init__(self, validators: list[Validator] | None = None):
        vals = sorted((v.copy() for v in validators or []),
                      key=lambda v: v.address)
        for a, b in zip(vals, vals[1:]):
            if a.address == b.address:
                raise ValueError(f"duplicate entry {a.address.hex()}")
        self.validators: list[Validator] = vals
        self._addr_index = {v.address: i for i, v in enumerate(vals)}
        total = sum(v.voting_power for v in vals)
        if total > MAX_TOTAL_VOTING_POWER:
            raise OverflowError(
                f"total voting power exceeds {MAX_TOTAL_VOTING_POWER}")
        self._total_voting_power = total
        self.proposer = (min(vals, key=lambda v: (-v.voting_power,
                                                  v.address))
                         if vals else None)

    def size(self) -> int:
        return len(self.validators)

    def get_by_index(self, index: int):
        if index < 0 or index >= len(self.validators):
            return None, None
        v = self.validators[index]
        return v.address, v

    def get_by_address(self, address: bytes):
        i = self._addr_index.get(address, -1)
        if i < 0:
            return -1, None
        return i, self.validators[i]

    def total_voting_power(self) -> int:
        return self._total_voting_power

    def all_keys_have_same_type(self) -> bool:
        types = {v.pub_key.type() if v.pub_key is not None else None
                 for v in self.validators}
        return len(types) <= 1

    def get_proposer(self) -> Validator | None:
        return self.proposer.copy() if self.proposer is not None else None

    def hash(self, device="cuda") -> bytes:
        """Merkle root over the validators' bytes; the leaf hashes run
        on `device` in one K10 launch from
        crypto/hash.DEVICE_HASH_THRESHOLD validators on (hashlib below)."""
        return merkle.hash_from_byte_slices_device(
            [v.bytes() for v in self.validators], device=device)
