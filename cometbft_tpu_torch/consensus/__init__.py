"""Consensus engine: WAL, state machine, reactor (the port's copy of
`cometbft_tpu.consensus`; CometBFT internal/consensus/)."""

from .wal import (  # noqa: F401
    WAL, WALMessage, EndHeightMessage, MsgInfo, TimeoutInfo,
    EventRoundState, DataCorruptionError,
)
