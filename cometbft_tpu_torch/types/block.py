"""BlockID, CommitSig and Commit (the port's copy of the parts of
`cometbft_tpu.types.block` that commit verification reads).

Proto layouts follow CometBFT proto/cometbft/types/v1/types.proto; the
class and field names match the JAX package's, so the error messages
that print a BlockID are byte-identical between the two.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

from .timestamp import Timestamp

BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3


class BlockIDFlag(IntEnum):
    ABSENT = 1
    COMMIT = 2
    NIL = 3


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and not self.hash


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_nil(self) -> bool:
        """IsNil in CometBFT: the zero BlockID."""
        return not self.hash and self.part_set_header.is_zero()


@dataclass(frozen=True)
class CommitSig:
    """One validator's precommit inside a Commit."""

    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp: Timestamp = field(default_factory=Timestamp.zero)
    signature: bytes = b""

    @staticmethod
    def absent() -> "CommitSig":
        return CommitSig()

    def validate_basic(self) -> None:
        if self.block_id_flag == BLOCK_ID_FLAG_ABSENT:
            if self.validator_address or self.signature \
                    or not self.timestamp.is_zero():
                raise ValueError("absent CommitSig must be empty")
            return
        if self.block_id_flag not in (BLOCK_ID_FLAG_COMMIT,
                                      BLOCK_ID_FLAG_NIL):
            raise ValueError(f"unknown BlockIDFlag {self.block_id_flag}")
        if len(self.validator_address) != 20:
            raise ValueError("expected 20-byte validator address")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > 64:
            raise ValueError("signature too big")


@dataclass
class Commit:
    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    signatures: list[CommitSig] = field(default_factory=list)

    def size(self) -> int:
        return len(self.signatures)

    def vote_sign_bytes_all(self, chain_id: str) -> list[bytes]:
        """Canonical sign-bytes for EVERY precommit of this commit, in
        signature order: signatures split into the two canonical-vote
        shapes (commit BlockID vs nil) and each group is assembled by one
        columnar splice (canonical.vote_sign_bytes_columnar).  Memoized
        per (chain_id, height, round, block_id)."""
        key = (chain_id, self.height, self.round, self.block_id)
        memo = getattr(self, "_sb_all", None)
        if memo is not None and memo[0] == key:
            return memo[1]
        from . import canonical
        sigs = self.signatures
        out: list[bytes] = [b""] * len(sigs)
        for for_block in (True, False):
            idx = [i for i, s in enumerate(sigs)
                   if (s.block_id_flag == BLOCK_ID_FLAG_COMMIT) == for_block]
            if not idx:
                continue
            rows = canonical.vote_sign_bytes_columnar(
                chain_id, canonical.PRECOMMIT, self.height, self.round,
                self.block_id if for_block else BlockID(),
                [sigs[i].timestamp for i in idx])
            for i, sb in zip(idx, rows):
                out[i] = sb
        self._sb_all = (key, out)
        return out
