"""Evidence gossip reactor (the port's copy of
`cometbft_tpu.evidence.reactor`; CometBFT internal/evidence/reactor.go).

Channel 0x38. Each peer gets a broadcast routine that walks the
pending-evidence list; incoming evidence goes through the pool's full
verification (on the pool's device) before being accepted and gossiped
on.  Only evidence that fails verification is blamed on its sender;
any other exception from the pool (a kernel that does not build, a
device fault) blames no peer and stays in `.error`.
"""

from __future__ import annotations

import threading
import time

from ..libs import protowire as pw
from ..p2p.base_reactor import Envelope, Reactor
from ..p2p.conn.connection import ChannelDescriptor
from ..types.evidence import (
    evidence_from_proto_wrapped, evidence_to_proto_wrapped,
)
from .pool import EvidencePool
from .verify import EvidenceVerificationError

EVIDENCE_CHANNEL = 0x38
BROADCAST_INTERVAL = 0.5


def encode_evidence_list(evidence: list) -> bytes:
    w = pw.Writer()
    for ev in evidence:
        w.message_field(1, evidence_to_proto_wrapped(ev))
    return w.bytes()


def decode_evidence_list(payload: bytes) -> list:
    r = pw.Reader(payload)
    out = []
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1 and w == pw.BYTES:
            out.append(evidence_from_proto_wrapped(r.read_bytes()))
        else:
            r.skip(w)
    return out


class EvidenceReactor(Reactor):
    def __init__(self, pool: EvidencePool):
        super().__init__("EvidenceReactor")
        self.pool = pool
        self.error: Exception | None = None
        self._peer_stops: dict[str, threading.Event] = {}

    def get_channels(self) -> list:
        return [ChannelDescriptor(EVIDENCE_CHANNEL, priority=6,
                                  send_queue_capacity=100,
                                  recv_message_capacity=32 * 1024 * 1024)]

    def add_peer(self, peer) -> None:
        stop = threading.Event()
        self._peer_stops[peer.id] = stop
        threading.Thread(target=self._broadcast_routine,
                         args=(peer, stop),
                         name=f"ev-bcast-{peer.id[:8]}",
                         daemon=True).start()

    def remove_peer(self, peer, reason) -> None:
        stop = self._peer_stops.pop(peer.id, None)
        if stop is not None:
            stop.set()

    def receive(self, envelope: Envelope) -> None:
        for ev in decode_evidence_list(bytes(envelope.message)):
            try:
                self.pool.add_evidence(ev)
            except EvidenceVerificationError:
                # invalid evidence: evict the sender (reactor.go:120)
                if self.switch is not None and envelope.src is not None:
                    self.switch.stop_peer_for_error(
                        envelope.src, "invalid evidence")
                return
            except (KeyError, ValueError):
                # not verifiable here yet (a height this node has not
                # stored): dropped, as the JAX package drops it
                return
            except Exception as e:                   # noqa: BLE001
                if self.error is None:
                    self.error = e
                return

    def _broadcast_routine(self, peer, stop: threading.Event) -> None:
        """reactor.go broadcastEvidenceRoutine: keep re-walking the
        pending list; sent set bounds re-sends per peer."""
        sent: set[bytes] = set()
        while not stop.is_set() and self.is_running():
            pending, _ = self.pool.pending_evidence(-1)
            for ev in pending:
                if stop.is_set() or not self.is_running():
                    return
                h = ev.hash()
                if h in sent:
                    continue
                if peer.send(EVIDENCE_CHANNEL,
                             encode_evidence_list([ev])):
                    sent.add(h)
            time.sleep(BROADCAST_INTERVAL)

    def on_stop(self) -> None:
        for stop in self._peer_stops.values():
            stop.set()
