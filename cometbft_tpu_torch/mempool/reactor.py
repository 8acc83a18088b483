"""Mempool gossip reactor (the port's copy of
`cometbft_tpu.mempool.reactor`; CometBFT mempool/reactor.go).

Channel 0x30. One broadcast routine per peer walks the mempool's
insertion-ordered entries via the sequence cursor (the clist-front
analog), skipping txs the peer itself sent us.
"""

from __future__ import annotations

import threading

from ..libs import protowire as pw
from ..p2p.base_reactor import Envelope, Reactor
from ..p2p.conn.connection import ChannelDescriptor
from . import clist_mempool as mp

MEMPOOL_CHANNEL = 0x30


def encode_txs(txs: list[bytes]) -> bytes:
    """mempool proto Message{Txs{repeated bytes txs}}, byte for byte the
    JAX package's."""
    inner = pw.Writer()
    for tx in txs:
        inner.bytes_field(1, tx)
    return pw.Writer().message_field(1, inner.bytes()).bytes()


def decode_txs(payload: bytes) -> list[bytes]:
    r = pw.Reader(payload)
    txs: list[bytes] = []
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1 and w == pw.BYTES:
            rr = pw.Reader(r.read_bytes())
            while not rr.at_end():
                ff, ww = rr.read_tag()
                if ff == 1 and ww == pw.BYTES:
                    txs.append(rr.read_bytes())
                else:
                    rr.skip(ww)
        else:
            r.skip(w)
    return txs


class MempoolReactor(Reactor):
    def __init__(self, mempool: mp.CListMempool, broadcast: bool = True):
        super().__init__("MempoolReactor")
        self.mempool = mempool
        self.broadcast_enabled = broadcast
        self._peer_threads: dict[str, threading.Thread] = {}
        self._peer_stops: dict[str, threading.Event] = {}

    def get_channels(self) -> list:
        return [ChannelDescriptor(
            MEMPOOL_CHANNEL, priority=5,
            send_queue_capacity=64,
            recv_message_capacity=self.mempool.max_tx_bytes * 10)]

    def add_peer(self, peer) -> None:
        if not self.broadcast_enabled:
            return
        stop = threading.Event()
        t = threading.Thread(target=self._broadcast_tx_routine,
                             args=(peer, stop),
                             name=f"mempool-bcast-{peer.id[:8]}",
                             daemon=True)
        self._peer_stops[peer.id] = stop
        self._peer_threads[peer.id] = t
        t.start()

    def remove_peer(self, peer, reason) -> None:
        stop = self._peer_stops.pop(peer.id, None)
        if stop is not None:
            stop.set()
        self._peer_threads.pop(peer.id, None)

    def receive(self, envelope: Envelope) -> None:
        """reactor.go:138: CheckTx with the sender recorded."""
        txs = decode_txs(envelope.message)
        src_id = envelope.src.id if envelope.src else ""
        for tx in txs:
            try:
                self.mempool.check_tx(tx, sender=src_id)
            except (mp.ErrTxInCache, mp.MempoolError):
                continue

    def _broadcast_tx_routine(self, peer, stop: threading.Event) -> None:
        """reactor.go:209: walk entries in order, dedup by sender."""
        cursor = 0
        while not stop.is_set() and self.is_running():
            if not self.mempool.wait_for_txs(cursor, timeout=0.2):
                continue
            for entry in self.mempool.entries_after(cursor):
                if stop.is_set() or not self.is_running():
                    return
                if peer.id not in entry.senders:
                    # retry until delivered or the peer dies — a slow
                    # peer must not permanently lose tx gossip
                    while not peer.send(MEMPOOL_CHANNEL,
                                        encode_txs([entry.tx]),
                                        timeout=1.0):
                        if stop.is_set() or not self.is_running() or \
                                not peer.is_running():
                            return
                cursor = max(cursor, entry.seq)

    def on_stop(self) -> None:
        for stop in self._peer_stops.values():
            stop.set()
