"""SignedHeader and LightBlock (the port's copy of
`cometbft_tpu.light.types`; CometBFT types/light.go)."""

from __future__ import annotations

from dataclasses import dataclass

from ..libs import protowire as pw
from ..ops import device as devmod
from ..types.block import Commit, Header
from ..types.validator_set import ValidatorSet


@dataclass
class SignedHeader:
    """A header and the commit that sealed it."""

    header: Header
    commit: Commit

    @property
    def height(self) -> int:
        return self.header.height

    @property
    def chain_id(self) -> str:
        return self.header.chain_id

    def hash(self) -> bytes | None:
        return self.header.hash()

    def validate_basic(self, chain_id: str) -> None:
        """Both parts valid, of this chain and height, the commit signing
        this header (types/light.go ValidateBasic)."""
        if self.header is None:
            raise ValueError("missing header")
        if self.commit is None:
            raise ValueError("missing commit")
        self.header.validate_basic()
        self.commit.validate_basic()
        if self.header.chain_id != chain_id:
            raise ValueError(
                f"header belongs to another chain {self.header.chain_id!r},"
                f" not {chain_id!r}")
        if self.commit.height != self.header.height:
            raise ValueError(
                f"header and commit height mismatch: {self.header.height} "
                f"vs {self.commit.height}")
        hhash = self.header.hash()
        if hhash != self.commit.block_id.hash:
            raise ValueError(
                f"commit signs block {self.commit.block_id.hash.hex()}, "
                f"header is block {hhash.hex()}")

    def to_proto(self) -> bytes:
        return (pw.Writer()
                .optional_message_field(1, self.header.to_proto())
                .optional_message_field(2, self.commit.to_proto())
                .bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "SignedHeader":
        r = pw.Reader(payload)
        header = commit = None
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                header = Header.from_proto(r.read_bytes())
            elif f == 2:
                commit = Commit.from_proto(r.read_bytes())
            else:
                r.skip(w)
        return SignedHeader(header, commit)


@dataclass
class LightBlock:
    """A signed header and its height's validator set."""

    signed_header: SignedHeader
    validator_set: ValidatorSet

    @property
    def height(self) -> int:
        return self.signed_header.height

    @property
    def header(self) -> Header:
        return self.signed_header.header

    def hash(self) -> bytes | None:
        return self.signed_header.hash()

    def validate_basic(self, chain_id: str, device="cuda") -> None:
        """Both parts valid and consistent: the header's validators hash
        is the set's, hashed on `device` (types/light.go ValidateBasic)."""
        devmod.resolve(device)
        if self.signed_header is None:
            raise ValueError("missing signed header")
        if self.validator_set is None:
            raise ValueError("missing validator set")
        self.signed_header.validate_basic(chain_id)
        self.validator_set.validate_basic()
        if self.signed_header.header.validators_hash != \
                self.validator_set.hash(device=device):
            raise ValueError(
                "expected validator hash of header to match validator set")

    def to_proto(self) -> bytes:
        return (pw.Writer()
                .optional_message_field(1, self.signed_header.to_proto())
                .optional_message_field(2, self.validator_set.to_proto())
                .bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "LightBlock":
        r = pw.Reader(payload)
        sh = vs = None
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                sh = SignedHeader.from_proto(r.read_bytes())
            elif f == 2:
                vs = ValidatorSet.from_proto(r.read_bytes())
            else:
                r.skip(w)
        return LightBlock(sh, vs)
