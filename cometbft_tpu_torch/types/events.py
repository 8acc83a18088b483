"""Typed event bus over pubsub (the port's copy of
`cometbft_tpu.types.events`; CometBFT types/event_bus.go,
types/events.go).

Consensus and the block executor publish here; the tx/block indexers
and RPC subscription endpoints consume. Attribute maps use composite
keys: `tm.event` plus every ABCI event flattened to `type.attr_key`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..libs import pubsub
from ..libs.service import BaseService

# types/events.go event values
EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_NEW_BLOCK_EVENTS = "NewBlockEvents"
EVENT_NEW_EVIDENCE = "NewEvidence"
EVENT_TX = "Tx"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_TIMEOUT_PROPOSE = "TimeoutPropose"
EVENT_TIMEOUT_WAIT = "TimeoutWait"
EVENT_NEW_ROUND = "NewRound"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_POLKA = "Polka"
EVENT_LOCK = "Lock"
EVENT_RELOCK = "Relock"
EVENT_VALID_BLOCK = "ValidBlock"
EVENT_VOTE = "Vote"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"
EVENT_PROPOSAL_BLOCK_PART = "ProposalBlockPart"

EVENT_TYPE_KEY = "tm.event"  # types/events.go EventTypeKey
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"
BLOCK_HEIGHT_KEY = "block.height"


def query_for_event(event_value: str) -> pubsub.Query:
    return pubsub.Query.parse(f"{EVENT_TYPE_KEY} = '{event_value}'")


def abci_events_to_map(abci_events, base: dict[str, list[str]] | None = None
                       ) -> dict[str, list[str]]:
    """Flatten ABCI events to `type.key` -> values (event_bus.go:60-80)."""
    out: dict[str, list[str]] = dict(base or {})
    for ev in abci_events or []:
        if not ev.type:
            continue
        for attr in ev.attributes:
            if not attr.key:
                continue
            out.setdefault(f"{ev.type}.{attr.key}", []).append(attr.value)
    return out


def block_events_map(height: int, abci_events) -> dict[str, list[str]]:
    """Composite map a NewBlockEvents publication (and hence the block
    indexer) sees — shared by the live event bus and `reindex-event` so
    the two can't drift."""
    events = abci_events_to_map(abci_events)
    events.setdefault(BLOCK_HEIGHT_KEY, []).append(str(height))
    return events


def tx_events_map(height: int, tx: bytes, abci_events
                  ) -> dict[str, list[str]]:
    """Composite map a Tx publication (and hence the tx indexer) sees —
    tx.height + tx.hash + flattened app events."""
    from .block import tx_hash

    events = abci_events_to_map(abci_events)
    events.setdefault(TX_HEIGHT_KEY, []).append(str(height))
    events.setdefault(TX_HASH_KEY, []).append(tx_hash(tx).hex().upper())
    return events


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
class EventDataRoundState:
    height: int = 0
    round: int = 0
    step: str = ""


@dataclass
class EventDataNewRound:
    height: int = 0
    round: int = 0
    step: str = ""
    proposer_address: bytes = b""
    proposer_index: int = -1


@dataclass
class EventDataCompleteProposal:
    height: int = 0
    round: int = 0
    step: str = ""
    block_id: object = None


@dataclass
class EventDataVote:
    vote: object = None


@dataclass
class EventDataValidatorSetUpdates:
    validator_updates: list = field(default_factory=list)


class EventBus(BaseService):
    """Publish API used across the engine (event_bus.go:34)."""

    def __init__(self):
        super().__init__("EventBus")
        self.server = pubsub.Server()

    def subscribe(self, subscriber: str, query: pubsub.Query,
                  capacity: int = 100) -> pubsub.Subscription:
        return self.server.subscribe(subscriber, query, capacity)

    def unsubscribe(self, subscriber: str, query: pubsub.Query) -> None:
        self.server.unsubscribe(subscriber, query)

    def unsubscribe_all(self, subscriber: str) -> None:
        self.server.unsubscribe_all(subscriber)

    def _publish(self, event_value: str, data: object,
                 events: dict[str, list[str]] | None = None) -> None:
        ev = dict(events or {})
        ev.setdefault(EVENT_TYPE_KEY, []).append(event_value)
        self.server.publish(data, ev)

    # -- typed publishers --------------------------------------------------
    def publish_new_block(self, data: EventDataNewBlock) -> None:
        events = abci_events_to_map(
            getattr(data.result_finalize_block, "events", None))
        h = data.block.header.height if data.block is not None else 0
        events.setdefault(BLOCK_HEIGHT_KEY, []).append(str(h))
        self._publish(EVENT_NEW_BLOCK, data, events)

    def publish_new_block_header(self, data: EventDataNewBlockHeader) -> None:
        self._publish(EVENT_NEW_BLOCK_HEADER, data)

    def publish_new_block_events(self, data: EventDataNewBlockEvents) -> None:
        events = block_events_map(data.height, data.events)
        self._publish(EVENT_NEW_BLOCK_EVENTS, data, events)

    def publish_new_evidence(self, data: EventDataNewEvidence) -> None:
        self._publish(EVENT_NEW_EVIDENCE, data)

    def publish_tx(self, data: EventDataTx) -> None:
        """Indexed with tx.hash and tx.height plus app events
        (event_bus.go PublishEventTx)."""
        events = tx_events_map(data.height, data.tx,
                               getattr(data.result, "events", None))
        self._publish(EVENT_TX, data, events)

    def publish_new_round_step(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_NEW_ROUND_STEP, data)

    def publish_timeout_propose(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_TIMEOUT_PROPOSE, data)

    def publish_timeout_wait(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_TIMEOUT_WAIT, data)

    def publish_new_round(self, data: EventDataNewRound) -> None:
        self._publish(EVENT_NEW_ROUND, data)

    def publish_complete_proposal(self,
                                  data: EventDataCompleteProposal) -> None:
        self._publish(EVENT_COMPLETE_PROPOSAL, data)

    def publish_polka(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_POLKA, data)

    def publish_lock(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_LOCK, data)

    def publish_relock(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_RELOCK, data)

    def publish_valid_block(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_VALID_BLOCK, data)

    def publish_vote(self, data: EventDataVote) -> None:
        self._publish(EVENT_VOTE, data)

    def publish_validator_set_updates(
            self, data: EventDataValidatorSetUpdates) -> None:
        self._publish(EVENT_VALIDATOR_SET_UPDATES, data)


class NopEventBus:
    """No-op bus for tests and light wiring."""

    def __getattr__(self, name):
        if name.startswith("publish"):
            return lambda *a, **k: None
        raise AttributeError(name)
