"""Byzantine evidence: verification and pooling (the port's copy of
`cometbft_tpu.evidence`; CometBFT internal/evidence/)."""

from .pool import EvidencePool  # noqa: F401
