"""Peer: MConnection + NodeInfo + per-peer data (the port's copy of
`cometbft_tpu.p2p.peer`; CometBFT p2p/peer.go, peer_set.go)."""

from __future__ import annotations

from ..libs import lockrank
from ..libs.service import BaseService
from .node_info import NodeInfo


class Peer(BaseService):
    def __init__(self, node_info: NodeInfo, mconn, outbound: bool,
                 persistent: bool = False, socket_addr: str = ""):
        super().__init__(f"Peer:{node_info.node_id[:10]}")
        self.node_info = node_info
        self.mconn = mconn
        self.outbound = outbound
        self.persistent = persistent
        self.socket_addr = socket_addr
        self._data: dict = {}
        self._data_mtx = lockrank.RankedLock("p2p.peer_data")

    @property
    def id(self) -> str:
        return self.node_info.node_id

    def on_start(self) -> None:
        self.mconn.start()

    def on_stop(self) -> None:
        self.mconn.stop()

    def send(self, channel_id: int, msg_bytes: bytes,
             timeout: float = 10.0, tctx=None) -> bool:
        """Blocking send onto the channel queue (peer.go Send).
        `tctx` is an optional trace context (libs/tracetl.py) carried
        to the remote reactor's Envelope when the wire supports it."""
        return self.mconn.send(channel_id, msg_bytes, timeout=timeout,
                               tctx=tctx)

    def try_send(self, channel_id: int, msg_bytes: bytes,
                 tctx=None) -> bool:
        return self.mconn.try_send(channel_id, msg_bytes, tctx=tctx)

    # per-peer key/value store (reactors stash PeerState here)
    def set(self, key: str, value) -> None:
        with self._data_mtx:
            self._data[key] = value

    def get(self, key: str):
        with self._data_mtx:
            return self._data.get(key)

    def status(self) -> dict:
        return self.mconn.status()


class PeerSet:
    """Thread-safe peer registry (p2p/peer_set.go)."""

    def __init__(self):
        self._mtx = lockrank.RankedLock("p2p.peer")
        self._by_id: dict[str, Peer] = {}

    def add(self, peer: Peer) -> None:
        with self._mtx:
            if peer.id in self._by_id:
                raise ValueError(f"duplicate peer {peer.id}")
            self._by_id[peer.id] = peer

    def has(self, peer_id: str) -> bool:
        with self._mtx:
            return peer_id in self._by_id

    def get(self, peer_id: str) -> Peer | None:
        with self._mtx:
            return self._by_id.get(peer_id)

    def remove(self, peer: Peer) -> bool:
        with self._mtx:
            return self._by_id.pop(peer.id, None) is not None

    def size(self) -> int:
        with self._mtx:
            return len(self._by_id)

    def list(self) -> list[Peer]:
        with self._mtx:
            return list(self._by_id.values())
