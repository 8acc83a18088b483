"""Light client: trust-minimized header verification (the port's copy of
`cometbft_tpu.light`), its commit checks on the card."""

from .types import SignedHeader, LightBlock  # noqa: F401
from .verifier import (  # noqa: F401
    verify, verify_adjacent, verify_non_adjacent, verify_backwards,
    header_expired, validate_trust_level, DEFAULT_TRUST_LEVEL,
)
from .client import Client, TrustOptions  # noqa: F401
