"""Switch: reactor registry + peer lifecycle (the port's copy of
`cometbft_tpu.p2p.switch`; CometBFT p2p/switch.go).

Reactors register channel descriptors; the switch upgrades inbound and
dialed connections into Peers, fans incoming packets out to the owning
reactor, broadcasts to all peers, evicts on error, and redials
persistent peers with exponential backoff.
"""

from __future__ import annotations

import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..libs import lockrank
from ..libs.service import BaseService
from .base_reactor import Envelope, Reactor
from .conn.connection import ChannelDescriptor, MConnection
from .node_info import NodeInfo
from .peer import Peer, PeerSet
from .transport import MultiplexTransport, parse_addr

MAX_NUM_INBOUND_PEERS = 40
MAX_NUM_OUTBOUND_PEERS = 10
RECONNECT_ATTEMPTS = 20
RECONNECT_BASE_WAIT = 1.0


class SwitchError(Exception):
    pass


class Switch(BaseService):
    def __init__(self, transport: MultiplexTransport,
                 listen_addr: str = ""):
        super().__init__("Switch")
        self.transport = transport
        self.listen_addr = listen_addr
        self.reactors: dict[str, Reactor] = {}
        self.channel_descs: list[ChannelDescriptor] = []
        self.reactors_by_ch: dict[int, Reactor] = {}
        self.peers = PeerSet()
        self.dialing: set[str] = set()
        # optional P2PMetrics (libs/metrics.py), assigned by the node
        self.metrics = None
        # optional conn wrapper applied to every peer connection before
        # the MConnection is built (latency emulation, fault injection)
        self.conn_wrap = None
        self.reconnecting: set[str] = set()
        self.persistent_peers: set[str] = set()  # addresses 'id@host:port'
        self._mtx = lockrank.RankedLock("p2p.switch")
        self._broadcast_pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="sw-bcast")
        self.bound_addr: str | None = None
        self.max_inbound = MAX_NUM_INBOUND_PEERS
        self.max_outbound = MAX_NUM_OUTBOUND_PEERS

    # -- reactors ----------------------------------------------------------
    def add_reactor(self, name: str, reactor: Reactor) -> Reactor:
        """switch.go:165 AddReactor."""
        for desc in reactor.get_channels():
            if desc.id in self.reactors_by_ch:
                raise SwitchError(
                    f"channel {desc.id:#x} already registered")
            self.channel_descs.append(desc)
            self.reactors_by_ch[desc.id] = reactor
        self.reactors[name] = reactor
        reactor.set_switch(self)
        return reactor

    def reactor(self, name: str) -> Reactor | None:
        return self.reactors.get(name)

    # -- lifecycle ---------------------------------------------------------
    def on_start(self) -> None:
        for reactor in self.reactors.values():
            reactor.start()
        if self.listen_addr:
            self.bound_addr = self.transport.listen(
                self.listen_addr, self._accept_peer)

    def on_stop(self) -> None:
        self.transport.close()
        for peer in self.peers.list():
            self.stop_peer_gracefully(peer)
        for reactor in self.reactors.values():
            reactor.stop()
        self._broadcast_pool.shutdown(wait=False)

    # -- peer intake -------------------------------------------------------
    def _accept_peer(self, conn, node_info: NodeInfo) -> None:
        inbound = sum(1 for p in self.peers.list() if not p.outbound)
        if inbound >= self.max_inbound:
            conn.close()
            return
        self._add_peer_conn(conn, node_info, outbound=False,
                            socket_addr=getattr(conn, "remote_addr", ""))

    def dial_peer(self, addr: str, persistent: bool = False) -> Peer:
        """Dial 'id@host:port' and add the peer (switch.go DialPeer...)."""
        peer_id, _, _ = parse_addr(addr)
        with self._mtx:
            if peer_id and (self.peers.has(peer_id)
                            or peer_id in self.dialing):
                raise SwitchError(f"already connected/dialing {peer_id}")
            self.dialing.add(peer_id)
        try:
            conn, node_info = self.transport.dial(addr)
            if persistent:
                self.persistent_peers.add(addr)
            return self._add_peer_conn(conn, node_info, outbound=True,
                                       persistent=persistent,
                                       socket_addr=addr)
        finally:
            with self._mtx:
                self.dialing.discard(peer_id)

    def dial_peers_async(self, addrs: list[str],
                         persistent: bool = False) -> None:
        for addr in addrs:
            threading.Thread(
                target=self._dial_ignore_errors, args=(addr, persistent),
                daemon=True).start()

    def _dial_ignore_errors(self, addr: str, persistent: bool) -> None:
        try:
            self.dial_peer(addr, persistent)
        except Exception:
            if persistent:
                self._reconnect_to(addr)

    def _add_peer_conn(self, conn, node_info: NodeInfo, outbound: bool,
                       persistent: bool = False,
                       socket_addr: str = "") -> Peer:
        peer_ref: list = [None]

        def on_receive(ch_id: int, msg_bytes: bytes, tctx=None) -> None:
            reactor = self.reactors_by_ch.get(ch_id)
            if reactor is None:
                raise SwitchError(f"no reactor for channel {ch_id:#x}")
            reactor.receive(Envelope(src=peer_ref[0], message=msg_bytes,
                                     channel_id=ch_id, tctx=tctx))

        def on_error(e: Exception) -> None:
            if peer_ref[0] is not None:
                self.stop_peer_for_error(peer_ref[0], e)

        if self.conn_wrap is not None:
            conn = self.conn_wrap(conn)
        mconn = MConnection(conn, self.channel_descs, on_receive,
                            on_error)
        mconn.metrics = self.metrics
        peer = Peer(node_info, mconn, outbound, persistent, socket_addr)
        peer_ref[0] = peer

        # reserve the peer slot atomically BEFORE touching reactor
        # state: a simultaneous cross-dial must not clobber the live
        # peer's reactor state or leak its connection
        try:
            self.peers.add(peer)
        except ValueError as e:
            conn.close()
            raise SwitchError(str(e)) from e
        self._update_peer_gauge()
        try:
            for reactor in self.reactors.values():
                reactor.init_peer(peer)
            peer.start()
            for reactor in self.reactors.values():
                reactor.add_peer(peer)
        except Exception:
            self.peers.remove(peer)
            self._update_peer_gauge()
            conn.close()
            raise
        return peer

    def _update_peer_gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.peers.set(self.peers.size())

    # -- peer removal ------------------------------------------------------
    def stop_peer_for_error(self, peer: Peer, reason) -> None:
        """switch.go:324."""
        if not self._remove_peer(peer, reason):
            return
        if peer.persistent and peer.socket_addr:
            threading.Thread(target=self._reconnect_to,
                             args=(peer.socket_addr,),
                             daemon=True).start()

    def stop_peer_gracefully(self, peer: Peer) -> None:
        self._remove_peer(peer, None)

    def _remove_peer(self, peer: Peer, reason) -> bool:
        if not self.peers.remove(peer):
            return False
        self._update_peer_gauge()
        peer.stop()
        for reactor in self.reactors.values():
            reactor.remove_peer(peer, reason)
        return True

    def _reconnect_to(self, addr: str) -> None:
        """Exponential backoff redial (switch.go:391)."""
        with self._mtx:
            if addr in self.reconnecting:
                return
            self.reconnecting.add(addr)
        try:
            for attempt in range(RECONNECT_ATTEMPTS):
                if not self.is_running():
                    return
                wait = RECONNECT_BASE_WAIT * (1.5 ** attempt) * \
                    (0.8 + 0.4 * random.random())
                time.sleep(min(wait, 30.0))
                try:
                    self.dial_peer(addr, persistent=True)
                    return
                except Exception:
                    continue
        finally:
            with self._mtx:
                self.reconnecting.discard(addr)

    # -- messaging ---------------------------------------------------------
    def broadcast(self, channel_id: int, msg_bytes: bytes) -> None:
        """Fan out to every peer (switch.go:271 Broadcast); returns
        immediately, sends run on a shared pool feeding the peers' send
        queues (not a thread per message)."""
        for peer in self.peers.list():
            self._broadcast_pool.submit(peer.send, channel_id, msg_bytes)

    def try_broadcast(self, channel_id: int, msg_bytes: bytes) -> None:
        for peer in self.peers.list():
            peer.try_send(channel_id, msg_bytes)

    def num_peers(self) -> dict:
        outbound = sum(1 for p in self.peers.list() if p.outbound)
        total = self.peers.size()
        return {"outbound": outbound, "inbound": total - outbound,
                "dialing": len(self.dialing)}
