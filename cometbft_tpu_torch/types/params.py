"""Consensus parameters (the port's copy of `cometbft_tpu.types.params`;
CometBFT types/params.go, params.proto).

ConsensusParams are part of replicated state: the app may update them at
every height (state/execution.go:609-626 in the reference), the header
commits to their hash (Header.consensus_hash), and feature gating
(vote extensions, PBTS) is by enable-height (types/params.go:80-95).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto.hash import sum_sha256
from ..libs import protowire as pw

ABCI_PUBKEY_TYPE_ED25519 = "ed25519"
ABCI_PUBKEY_TYPE_SECP256K1 = "secp256k1"
ABCI_PUBKEY_TYPE_BLS12381 = "bls12_381"

MAX_BLOCK_SIZE_BYTES = 104857600  # 100 MiB, types/params.go MaxBlockSizeBytes


def _duration_proto(nanos_total: int) -> bytes:
    """google.protobuf.Duration {seconds:1, nanos:2}."""
    secs, nanos = divmod(nanos_total, 1_000_000_000)
    return pw.Writer().int_field(1, secs).int_field(2, nanos).bytes()


def _duration_from_proto(payload: bytes) -> int:
    r = pw.Reader(payload)
    secs, nanos = 0, 0
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1 and w == pw.VARINT:
            secs = r.read_int()
        elif f == 2 and w == pw.VARINT:
            nanos = r.read_int()
        else:
            r.skip(w)
    return secs * 1_000_000_000 + nanos


def _int64_value(v: int) -> bytes:
    """google.protobuf.Int64Value wrapper {value:1}."""
    return pw.Writer().int_field(1, v).bytes()


def _int64_value_from(payload: bytes) -> int:
    r = pw.Reader(payload)
    v = 0
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1 and w == pw.VARINT:
            v = r.read_int()
        else:
            r.skip(w)
    return v


@dataclass
class BlockParams:
    max_bytes: int = 4194304      # 4 MiB default (types/params.go:120)
    max_gas: int = -1

    def to_proto(self) -> bytes:
        return (pw.Writer().int_field(1, self.max_bytes)
                .int_field(2, self.max_gas).bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "BlockParams":
        r = pw.Reader(payload)
        p = BlockParams(max_bytes=0, max_gas=0)
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                p.max_bytes = r.read_int()
            elif f == 2 and w == pw.VARINT:
                p.max_gas = r.read_int()
            else:
                r.skip(w)
        return p

    def validate(self) -> None:
        if self.max_bytes == 0 or self.max_bytes < -1:
            raise ValueError(f"block.MaxBytes must be -1 or >0: "
                             f"{self.max_bytes}")
        if self.max_bytes > MAX_BLOCK_SIZE_BYTES:
            raise ValueError("block.MaxBytes too big")
        if self.max_gas < -1:
            raise ValueError(f"block.MaxGas must be >= -1: {self.max_gas}")


@dataclass
class EvidenceParams:
    max_age_num_blocks: int = 100000
    max_age_duration_ns: int = 48 * 3600 * 1_000_000_000  # 48h
    max_bytes: int = 1048576  # 1 MiB

    def to_proto(self) -> bytes:
        return (pw.Writer().int_field(1, self.max_age_num_blocks)
                .message_field(2, _duration_proto(self.max_age_duration_ns))
                .int_field(3, self.max_bytes).bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "EvidenceParams":
        r = pw.Reader(payload)
        p = EvidenceParams(0, 0, 0)
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                p.max_age_num_blocks = r.read_int()
            elif f == 2 and w == pw.BYTES:
                p.max_age_duration_ns = _duration_from_proto(r.read_bytes())
            elif f == 3 and w == pw.VARINT:
                p.max_bytes = r.read_int()
            else:
                r.skip(w)
        return p

    def validate(self) -> None:
        if self.max_age_num_blocks <= 0:
            raise ValueError("evidence.MaxAgeNumBlocks must be positive")
        if self.max_age_duration_ns <= 0:
            raise ValueError("evidence.MaxAgeDuration must be positive")
        if self.max_bytes < 0:
            raise ValueError("evidence.MaxBytes must be non-negative")


@dataclass
class ValidatorParams:
    pub_key_types: list = field(
        default_factory=lambda: [ABCI_PUBKEY_TYPE_ED25519])

    def to_proto(self) -> bytes:
        w = pw.Writer()
        for t in self.pub_key_types:
            w.string_field(1, t)
        return w.bytes()

    @staticmethod
    def from_proto(payload: bytes) -> "ValidatorParams":
        r = pw.Reader(payload)
        types: list[str] = []
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                types.append(r.read_string())
            else:
                r.skip(w)
        return ValidatorParams(pub_key_types=types)

    def validate(self) -> None:
        if not self.pub_key_types:
            raise ValueError("validator.PubKeyTypes must not be empty")
        known = {ABCI_PUBKEY_TYPE_ED25519, ABCI_PUBKEY_TYPE_SECP256K1,
                 ABCI_PUBKEY_TYPE_BLS12381}
        for t in self.pub_key_types:
            if t not in known:
                raise ValueError(f"unknown pubkey type {t!r}")


@dataclass
class VersionParams:
    app: int = 0

    def to_proto(self) -> bytes:
        return pw.Writer().uvarint_field(1, self.app).bytes()

    @staticmethod
    def from_proto(payload: bytes) -> "VersionParams":
        r = pw.Reader(payload)
        p = VersionParams()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                p.app = r.read_uvarint()
            else:
                r.skip(w)
        return p


@dataclass
class SynchronyParams:
    """PBTS bounds (types/params.go SynchronyParams)."""
    precision_ns: int = 505_000_000        # 505ms default
    message_delay_ns: int = 15_000_000_000  # 15s default

    def to_proto(self) -> bytes:
        return (pw.Writer()
                .message_field(1, _duration_proto(self.precision_ns))
                .message_field(2, _duration_proto(self.message_delay_ns))
                .bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "SynchronyParams":
        r = pw.Reader(payload)
        p = SynchronyParams(0, 0)
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                p.precision_ns = _duration_from_proto(r.read_bytes())
            elif f == 2 and w == pw.BYTES:
                p.message_delay_ns = _duration_from_proto(r.read_bytes())
            else:
                r.skip(w)
        return p

    def validate(self) -> None:
        if self.precision_ns <= 0:
            raise ValueError("synchrony.Precision must be positive")
        if self.message_delay_ns <= 0:
            raise ValueError("synchrony.MessageDelay must be positive")


@dataclass
class FeatureParams:
    """Height-gated features (types/params.go:80-95). 0 = disabled."""
    vote_extensions_enable_height: int = 0
    pbts_enable_height: int = 0

    def to_proto(self) -> bytes:
        w = pw.Writer()
        # Int64Value wrappers, nullable: emit only when set
        if self.vote_extensions_enable_height:
            w.message_field(1, _int64_value(
                self.vote_extensions_enable_height))
        if self.pbts_enable_height:
            w.message_field(2, _int64_value(self.pbts_enable_height))
        return w.bytes()

    @staticmethod
    def from_proto(payload: bytes) -> "FeatureParams":
        r = pw.Reader(payload)
        p = FeatureParams()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                p.vote_extensions_enable_height = _int64_value_from(
                    r.read_bytes())
            elif f == 2 and w == pw.BYTES:
                p.pbts_enable_height = _int64_value_from(r.read_bytes())
            else:
                r.skip(w)
        return p

    def validate(self) -> None:
        if self.vote_extensions_enable_height < 0:
            raise ValueError("feature.VoteExtensionsEnableHeight must be "
                             "non-negative")
        if self.pbts_enable_height < 0:
            raise ValueError("feature.PbtsEnableHeight must be non-negative")


@dataclass
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)
    version: VersionParams = field(default_factory=VersionParams)
    synchrony: SynchronyParams = field(default_factory=SynchronyParams)
    feature: FeatureParams = field(default_factory=FeatureParams)

    # -- feature gates -----------------------------------------------------

    def vote_extensions_enabled(self, height: int) -> bool:
        h = self.feature.vote_extensions_enable_height
        return h != 0 and height >= h

    def pbts_enabled(self, height: int) -> bool:
        h = self.feature.pbts_enable_height
        return h != 0 and height >= h

    # -- wire --------------------------------------------------------------

    def to_proto(self) -> bytes:
        return (pw.Writer()
                .message_field(1, self.block.to_proto())
                .message_field(2, self.evidence.to_proto())
                .message_field(3, self.validator.to_proto())
                .message_field(4, self.version.to_proto())
                .message_field(6, self.synchrony.to_proto())
                .message_field(7, self.feature.to_proto())
                .bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "ConsensusParams":
        r = pw.Reader(payload)
        p = ConsensusParams()
        while not r.at_end():
            f, w = r.read_tag()
            if w != pw.BYTES:
                r.skip(w)
                continue
            buf = r.read_bytes()
            if f == 1:
                p.block = BlockParams.from_proto(buf)
            elif f == 2:
                p.evidence = EvidenceParams.from_proto(buf)
            elif f == 3:
                p.validator = ValidatorParams.from_proto(buf)
            elif f == 4:
                p.version = VersionParams.from_proto(buf)
            elif f == 6:
                p.synchrony = SynchronyParams.from_proto(buf)
            elif f == 7:
                p.feature = FeatureParams.from_proto(buf)
        return p

    # -- semantics ---------------------------------------------------------

    def hash(self) -> bytes:
        """SHA-256 of HashedParams (block max_bytes/max_gas only), matching
        types/params.go HashConsensusParams."""
        hp = (pw.Writer().int_field(1, self.block.max_bytes)
              .int_field(2, self.block.max_gas).bytes())
        return sum_sha256(hp)

    def validate(self) -> None:
        self.block.validate()
        self.evidence.validate()
        self.validator.validate()
        self.synchrony.validate()
        self.feature.validate()
        # -1 means unlimited block size (types/params.go:242-245)
        block_max = (MAX_BLOCK_SIZE_BYTES if self.block.max_bytes == -1
                     else self.block.max_bytes)
        if self.evidence.max_bytes > block_max:
            raise ValueError("evidence.MaxBytes exceeds block.MaxBytes")

    def merge_proto_updates(self, payload: bytes) -> "ConsensusParams":
        """ABCI ConsensusParamUpdates: a partial ConsensusParams proto
        where absent sub-messages mean "keep current"
        (types/params.go Update)."""
        r = pw.Reader(payload)
        kwargs = {}
        while not r.at_end():
            f, w = r.read_tag()
            if w != pw.BYTES:
                r.skip(w)
                continue
            buf = r.read_bytes()
            if f == 1:
                kwargs["block"] = BlockParams.from_proto(buf)
            elif f == 2:
                kwargs["evidence"] = EvidenceParams.from_proto(buf)
            elif f == 3:
                kwargs["validator"] = ValidatorParams.from_proto(buf)
            elif f == 4:
                kwargs["version"] = VersionParams.from_proto(buf)
            elif f == 6:
                kwargs["synchrony"] = SynchronyParams.from_proto(buf)
            elif f == 7:
                kwargs["feature"] = FeatureParams.from_proto(buf)
        return self.update(**kwargs)

    def update(self, *, block=None, evidence=None, validator=None,
               version=None, synchrony=None, feature=None
               ) -> "ConsensusParams":
        """Return a copy with the given sub-params replaced (ABCI
        ConsensusParamUpdates semantics: nil sub-message = keep)."""
        return ConsensusParams(
            block=block if block is not None else self.block,
            evidence=evidence if evidence is not None else self.evidence,
            validator=validator if validator is not None else self.validator,
            version=version if version is not None else self.version,
            synchrony=synchrony if synchrony is not None else self.synchrony,
            feature=feature if feature is not None else self.feature,
        )
