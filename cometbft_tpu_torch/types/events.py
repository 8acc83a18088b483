"""Event data published by the block executor (the port's copy of the
parts of `cometbft_tpu.types.events` that state/execution.py uses;
CometBFT types/events.go).

The typed EventBus over libs/pubsub, the composite attribute maps the
indexers read and the consensus events are not ported yet: an executor
without a bus publishes to NopEventBus.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class EventDataTx:
    height: int = 0
    index: int = 0
    tx: bytes = b""
    result: object = None  # abci.ExecTxResult


@dataclass
class EventDataNewBlock:
    block: object = None
    block_id: object = None
    result_finalize_block: object = None


@dataclass
class EventDataNewBlockHeader:
    header: object = None


@dataclass
class EventDataNewBlockEvents:
    height: int = 0
    events: list = field(default_factory=list)
    num_txs: int = 0


@dataclass
class EventDataNewEvidence:
    height: int = 0
    evidence: object = None


@dataclass
class EventDataValidatorSetUpdates:
    validator_updates: list = field(default_factory=list)


class NopEventBus:
    """No-op bus for tests and light wiring."""

    def __getattr__(self, name):
        if name.startswith("publish"):
            return lambda *a, **k: None
        raise AttributeError(name)
