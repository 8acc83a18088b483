"""MultiplexTransport: TCP listen/dial + connection upgrade (the port's
copy of `cometbft_tpu.p2p.transport`; CometBFT p2p/transport.go).

upgrade = SecretConnection handshake (authenticates the peer key) +
length-prefixed NodeInfo exchange + compatibility filters.
"""

from __future__ import annotations

import socket
import struct
import threading

from .conn.secret_connection import SecretConnection
from .key import NodeKey, node_id_from_pubkey
from .node_info import MAX_NODE_INFO_SIZE, NodeInfo, NodeInfoError

HANDSHAKE_TIMEOUT = 20.0
DIAL_TIMEOUT = 3.0


class TransportError(Exception):
    pass


class ErrRejected(TransportError):
    pass


def parse_addr(addr: str) -> tuple[str, str, int]:
    """'id@host:port' or 'host:port' -> (id, host, port)."""
    peer_id = ""
    if "@" in addr:
        peer_id, addr = addr.split("@", 1)
    addr = addr.replace("tcp://", "")
    host, _, port = addr.rpartition(":")
    return peer_id, host or "127.0.0.1", int(port)


class MultiplexTransport:
    def __init__(self, node_key: NodeKey, node_info: NodeInfo,
                 handshake_timeout: float = HANDSHAKE_TIMEOUT):
        self.node_key = node_key
        self.node_info = node_info
        self.handshake_timeout = handshake_timeout
        self._listener: socket.socket | None = None
        self._accept_cb = None
        self._accept_thread: threading.Thread | None = None
        self._closed = False
        # conn filters: callables(raw socket) raising to reject
        self.conn_filters: list = []

    # -- listening ---------------------------------------------------------
    def listen(self, addr: str, accept_cb) -> str:
        """Start accepting; accept_cb(secret_conn, node_info) runs per
        upgraded inbound connection. Returns the bound address."""
        _, host, port = parse_addr(addr)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self._accept_cb = accept_cb
        self._accept_thread = threading.Thread(
            target=self._accept_routine, name="transport-accept",
            daemon=True)
        self._accept_thread.start()
        bound_host, bound_port = self._listener.getsockname()
        return f"{bound_host}:{bound_port}"

    def _accept_routine(self) -> None:
        while not self._closed:
            try:
                raw, _addr = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._handle_inbound, args=(raw,),
                             daemon=True).start()

    def _handle_inbound(self, raw: socket.socket) -> None:
        try:
            peername = "%s:%d" % raw.getpeername()[:2]
        except OSError:
            peername = ""
        try:
            conn, info = self.upgrade(raw, expected_id="")
            conn.remote_addr = peername
        except Exception:
            try:
                raw.close()
            except OSError:
                pass
            return
        try:
            self._accept_cb(conn, info)
        except Exception:
            conn.close()

    # -- dialing -----------------------------------------------------------
    def dial(self, addr: str) -> tuple[SecretConnection, NodeInfo]:
        """Outbound connect + upgrade; verifies the peer ID when the
        address pins one ('id@host:port')."""
        peer_id, host, port = parse_addr(addr)
        raw = socket.create_connection((host, port), timeout=DIAL_TIMEOUT)
        return self.upgrade(raw, expected_id=peer_id)

    # -- upgrade -----------------------------------------------------------
    def upgrade(self, raw: socket.socket, expected_id: str
                ) -> tuple[SecretConnection, NodeInfo]:
        """transport.go:411: secret handshake, filters, NodeInfo swap."""
        raw.settimeout(self.handshake_timeout)
        raw.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        for f in self.conn_filters:
            f(raw)

        conn = SecretConnection.make(raw, self.node_key.priv_key)
        actual_id = node_id_from_pubkey(conn.remote_pubkey)
        if expected_id and actual_id != expected_id:
            conn.close()
            raise ErrRejected(
                f"peer ID mismatch: dialed {expected_id}, got {actual_id}")

        # NodeInfo exchange: 4-byte length prefix + proto
        payload = self.node_info.to_proto()
        conn.write(struct.pack(">I", len(payload)) + payload)
        their_info = self._read_node_info(conn)

        their_info.validate_basic()
        if their_info.node_id != actual_id:
            conn.close()
            raise ErrRejected(
                f"NodeInfo ID {their_info.node_id} != handshake ID "
                f"{actual_id}")
        if their_info.node_id == self.node_info.node_id:
            conn.close()
            raise ErrRejected("connected to self")
        try:
            self.node_info.compatible_with(their_info)
        except NodeInfoError as e:
            conn.close()
            raise ErrRejected(str(e)) from e

        raw.settimeout(None)
        return conn, their_info

    @staticmethod
    def _read_node_info(conn: SecretConnection) -> NodeInfo:
        buf = b""
        while len(buf) < 4:
            chunk = conn.read()
            if not chunk:
                raise TransportError("EOF during NodeInfo exchange")
            buf += chunk
        (n,) = struct.unpack_from(">I", buf)
        if n > MAX_NODE_INFO_SIZE:
            raise TransportError("NodeInfo too large")
        buf = buf[4:]
        while len(buf) < n:
            chunk = conn.read()
            if not chunk:
                raise TransportError("EOF during NodeInfo exchange")
            buf += chunk
        return NodeInfo.from_proto(buf[:n])

    def close(self) -> None:
        self._closed = True
        if self._listener is not None:
            # shutdown() first: close() alone does not wake the accept
            # thread blocked in accept() on the listening socket
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        t, self._accept_thread = self._accept_thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
