"""MConnection: per-peer multiplexed connection (the port's copy of
`cometbft_tpu.p2p.conn.connection`; CometBFT p2p/conn/connection.go).

N priority channels share one encrypted stream. Messages are split into
<=1024-byte packets; the send routine repeatedly picks the channel with
the lowest recently-sent/priority ratio (connection.go sendPacketMsg),
batching packets for up to the 10ms flush throttle. Ping/pong probes
detect dead peers; send and receive are rate-limited via flowrate
monitors.
"""

from __future__ import annotations

import queue
import struct
import threading
import time

from ...libs import protowire as pw
from ...libs.flowrate import Monitor
from ...libs.service import BaseService

MAX_PACKET_MSG_PAYLOAD_SIZE = 1024
FLUSH_THROTTLE = 0.01          # 10ms (connection.go:38)
PING_INTERVAL = 60.0
PONG_TIMEOUT = 45.0
DEFAULT_SEND_RATE = 5 * 1024 * 1024  # 5 MB/s (config.go)
DEFAULT_RECV_RATE = 5 * 1024 * 1024
DEFAULT_SEND_QUEUE_CAPACITY = 1
DEFAULT_RECV_MESSAGE_CAPACITY = 22 * 1024 * 1024


class MConnectionError(Exception):
    pass


# -- packet wire format (conn.proto Packet oneof) ---------------------------

def _pack_ping() -> bytes:
    return pw.Writer().message_field(1, b"").bytes()


def _pack_pong() -> bytes:
    return pw.Writer().message_field(2, b"").bytes()


def _pack_msg(channel_id: int, eof: bool, data: bytes) -> bytes:
    inner = (pw.Writer().uvarint_field(1, channel_id)
             .bool_field(2, eof).bytes_field(3, data).bytes())
    return pw.Writer().message_field(3, inner).bytes()


def _pack_ctx(channel_id: int, ctx) -> bytes:
    """Oneof field 4 (this repo's extension): a trace context
    (libs/tracetl.py (origin, height, round, seq)) for the NEXT
    msg-EOF on `channel_id`.  Real-TCP conns cannot ship the per-frame
    context list the simnet transport carries out-of-band, so the
    context rides the wire as its own tiny packet immediately ahead of
    the message-EOF packet it describes — which is what makes
    cross-PROCESS flow edges and NTP-style clock-offset solving
    (fleetobs/clocksync.py) possible on real testnets."""
    origin, height, round_, seq = ctx
    inner = (pw.Writer().uvarint_field(1, channel_id)
             .bytes_field(2, str(origin).encode())
             .uvarint_field(3, int(height)).uvarint_field(4, int(round_))
             .uvarint_field(5, int(seq)).bytes())
    return pw.Writer().message_field(4, inner).bytes()


def _unpack_packet(payload: bytes):
    """-> ('ping'|'pong'|'msg', channel_id, eof, data)
    or ('ctx', channel_id, False, (origin, height, round, seq))."""
    r = pw.Reader(payload)
    while not r.at_end():
        f, w = r.read_tag()
        if w != pw.BYTES:
            r.skip(w)
            continue
        body = r.read_bytes()
        if f == 1:
            return ("ping", 0, False, b"")
        if f == 2:
            return ("pong", 0, False, b"")
        if f == 3:
            rr = pw.Reader(body)
            ch, eof, data = 0, False, b""
            while not rr.at_end():
                ff, ww = rr.read_tag()
                if ff == 1 and ww == pw.VARINT:
                    ch = rr.read_uvarint()
                elif ff == 2 and ww == pw.VARINT:
                    eof = bool(rr.read_uvarint())
                elif ff == 3 and ww == pw.BYTES:
                    data = rr.read_bytes()
                else:
                    rr.skip(ww)
            return ("msg", ch, eof, data)
        if f == 4:
            rr = pw.Reader(body)
            ch, origin, height, round_, seq = 0, "", 0, 0, 0
            while not rr.at_end():
                ff, ww = rr.read_tag()
                if ff == 1 and ww == pw.VARINT:
                    ch = rr.read_uvarint()
                elif ff == 2 and ww == pw.BYTES:
                    origin = rr.read_bytes().decode("utf-8", "replace")
                elif ff == 3 and ww == pw.VARINT:
                    height = rr.read_uvarint()
                elif ff == 4 and ww == pw.VARINT:
                    round_ = rr.read_uvarint()
                elif ff == 5 and ww == pw.VARINT:
                    seq = rr.read_uvarint()
                else:
                    rr.skip(ww)
            return ("ctx", ch, False, (origin, height, round_, seq))
        r.skip(w)
    raise MConnectionError("empty packet")


class ChannelDescriptor:
    """connection.go:748 ChannelDescriptor."""

    def __init__(self, channel_id: int, priority: int = 1,
                 send_queue_capacity: int = DEFAULT_SEND_QUEUE_CAPACITY,
                 recv_message_capacity: int = DEFAULT_RECV_MESSAGE_CAPACITY,
                 recv_buffer_capacity: int = 4096):
        self.id = channel_id
        self.priority = max(priority, 1)
        self.send_queue_capacity = send_queue_capacity
        self.recv_message_capacity = recv_message_capacity
        self.recv_buffer_capacity = recv_buffer_capacity


class _Channel:
    """connection.go channel: send queue + recv reassembly buffer."""

    def __init__(self, desc: ChannelDescriptor):
        self.desc = desc
        # queue of (msg_bytes, trace_ctx_or_None): the context rides
        # next to the message through packetization so the EOF packet
        # of THIS message — and nothing else — carries it on the wire
        self.send_queue: queue.Queue[tuple] = queue.Queue(
            desc.send_queue_capacity)
        self.sending: bytes | None = None
        self.sending_ctx = None
        self.sent_pos = 0
        self.recently_sent = 0       # exponentially decayed
        self.recv_buf = b""

    def is_send_pending(self) -> bool:
        return self.sending is not None or not self.send_queue.empty()

    def next_packet(self) -> tuple:
        """Pop the next <=1024-byte packet of the in-flight message;
        -> (packet, eof, trace_ctx) — ctx is meaningful only at eof."""
        if self.sending is None:
            self.sending, self.sending_ctx = self.send_queue.get_nowait()
            self.sent_pos = 0
        chunk = self.sending[self.sent_pos:
                             self.sent_pos + MAX_PACKET_MSG_PAYLOAD_SIZE]
        self.sent_pos += len(chunk)
        eof = self.sent_pos >= len(self.sending)
        pkt = _pack_msg(self.desc.id, eof, chunk)
        ctx = None
        if eof:
            ctx = self.sending_ctx
            self.sending = None
            self.sending_ctx = None
            self.sent_pos = 0
        self.recently_sent += len(pkt)
        return pkt, eof, ctx

    def recv_packet(self, eof: bool, data: bytes) -> bytes | None:
        """Append a packet; return the whole message when eof."""
        if len(self.recv_buf) + len(data) > \
                self.desc.recv_message_capacity:
            raise MConnectionError(
                f"recv msg exceeds capacity on channel {self.desc.id}")
        self.recv_buf += data
        if eof:
            msg, self.recv_buf = self.recv_buf, b""
            return msg
        return None


class MConnection(BaseService):
    def __init__(self, conn, channel_descs, on_receive, on_error,
                 send_rate: int = DEFAULT_SEND_RATE,
                 recv_rate: int = DEFAULT_RECV_RATE,
                 ping_interval: float = PING_INTERVAL,
                 pong_timeout: float = PONG_TIMEOUT,
                 flush_throttle: float = FLUSH_THROTTLE):
        """conn: a SecretConnection-like object (write/read/close);
        on_receive(channel_id, msg_bytes[, tctx]); on_error(exc)."""
        super().__init__("MConnection")
        self._conn = conn
        # trace-context carry (libs/tracetl.py): conns that can ship a
        # per-message context list with each frame (the simnet conn)
        # expose write_with_ctx/pop_recv_ctx; everything else (real
        # TCP + SecretConnection, chaos wrappers) degrades to plain
        # writes and contexts simply do not travel
        self._write_with_ctx = getattr(conn, "write_with_ctx", None)
        self._pop_recv_ctx = getattr(conn, "pop_recv_ctx", None)
        try:
            import inspect
            params = inspect.signature(on_receive).parameters
            self._recv_takes_ctx = len(params) >= 3 or any(
                p.kind == p.VAR_POSITIONAL for p in params.values())
        except (TypeError, ValueError):
            self._recv_takes_ctx = False
        # optional P2PMetrics (libs/metrics.py), assigned by the switch:
        # per-channel framed-byte counters at the wire seam
        self.metrics = None
        self._channels: dict[int, _Channel] = {
            d.id: _Channel(d) for d in channel_descs}
        self._on_receive = on_receive
        self._on_error = on_error
        self._send_rate = send_rate
        self._recv_rate = recv_rate
        self._ping_interval = ping_interval
        self._pong_timeout = pong_timeout
        self._flush_throttle = flush_throttle
        self._send_monitor = Monitor()
        self._recv_monitor = Monitor()
        # per-channel pending recv context from in-band ctx packets
        # (real-TCP carry); only the recv routine's thread touches it
        self._recv_pending_ctx: dict = {}
        self._send_signal = threading.Event()
        self._pong_pending = threading.Event()
        self._pong_deadline: float | None = None
        self._last_ping = time.monotonic()
        self._threads: list[threading.Thread] = []

    def on_start(self) -> None:
        for target, name in ((self._send_routine, "mconn-send"),
                             (self._recv_routine, "mconn-recv")):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def on_stop(self) -> None:
        self._send_signal.set()
        self._conn.close()

    # -- sending -----------------------------------------------------------
    def send(self, channel_id: int, msg_bytes: bytes,
             timeout: float = 10.0, tctx=None) -> bool:
        """Queue a message; False if the channel queue stays full
        (connection.go Send).  `tctx` is an optional trace context
        delivered to the remote reactor with the message."""
        if not self.is_running():
            return False
        ch = self._channels.get(channel_id)
        if ch is None:
            return False
        try:
            ch.send_queue.put((msg_bytes, tctx), timeout=timeout)
        except queue.Full:
            return False
        self._send_signal.set()
        return True

    def try_send(self, channel_id: int, msg_bytes: bytes,
                 tctx=None) -> bool:
        if not self.is_running():
            return False
        ch = self._channels.get(channel_id)
        if ch is None:
            return False
        try:
            ch.send_queue.put_nowait((msg_bytes, tctx))
        except queue.Full:
            return False
        self._send_signal.set()
        return True

    def _select_channel(self) -> _Channel | None:
        """Least ratio of recently_sent/priority wins
        (connection.go sendPacketMsg)."""
        best, best_ratio = None, None
        for ch in self._channels.values():
            if not ch.is_send_pending():
                continue
            ratio = ch.recently_sent / ch.desc.priority
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = ch, ratio
        return best

    def _send_routine(self) -> None:
        try:
            while self.is_running():
                fired = self._send_signal.wait(
                    timeout=self._ping_interval / 10)
                self._send_signal.clear()
                if not self.is_running():
                    return

                # ping if due; length-prefixed like every packet (the
                # recv routine frames the stream on 4-byte prefixes, so
                # a bare ping would desync everything after it)
                now = time.monotonic()
                if now - self._last_ping >= self._ping_interval:
                    pkt = _pack_ping()
                    self._conn.write(struct.pack(">I", len(pkt)) + pkt)
                    self._last_ping = now
                    self._pong_deadline = now + self._pong_timeout
                if self._pong_pending.is_set():
                    self._pong_pending.clear()
                    pkt = _pack_pong()
                    self._conn.write(struct.pack(">I", len(pkt)) + pkt)
                if self._pong_deadline is not None and \
                        now > self._pong_deadline:
                    raise MConnectionError("pong timeout")

                # drain packets, decaying counters; batch <= throttle
                deadline = time.monotonic() + self._flush_throttle
                batch = []
                batch_ctxs = []          # one entry per msg-EOF packet
                batch_bytes = 0
                rate_limited = False
                while True:
                    allowed = self._send_monitor.limit(
                        MAX_PACKET_MSG_PAYLOAD_SIZE + 64,
                        self._send_rate, block=False)
                    if allowed == 0:
                        rate_limited = True
                        break
                    ch = self._select_channel()
                    if ch is None:
                        break
                    pkt, eof, ctx = ch.next_packet()
                    if eof and ctx is not None \
                            and self._write_with_ctx is None:
                        # real TCP: the context travels in-band as its
                        # own packet just ahead of the EOF it describes
                        cpkt = _pack_ctx(ch.desc.id, ctx)
                        batch.append(cpkt)
                        batch_bytes += len(cpkt)
                        self._send_monitor.update(len(cpkt))
                    batch.append(pkt)
                    if eof:
                        batch_ctxs.append(ctx)
                    batch_bytes += len(pkt)
                    self._send_monitor.update(len(pkt))
                    if self.metrics is not None:
                        # framed length: prefix + packet, the bytes the
                        # wire actually carries for this channel
                        self.metrics.message_send_bytes_total.labels(
                            "%#x" % ch.desc.id).add(4 + len(pkt))
                    if time.monotonic() >= deadline or \
                            batch_bytes > 64 * 1024:
                        self._flush_batch(batch, batch_ctxs)
                        batch, batch_ctxs, batch_bytes = [], [], 0
                        deadline = time.monotonic() + self._flush_throttle
                if batch:
                    self._flush_batch(batch, batch_ctxs)
                # decay sent counters (connection.go: 0.8 every 2s; we
                # decay proportionally per wakeup)
                for ch in self._channels.values():
                    ch.recently_sent = int(ch.recently_sent * 0.95)
                if any(c.is_send_pending()
                       for c in self._channels.values()):
                    if rate_limited:
                        # wait for bucket refill instead of busy-spinning
                        time.sleep(0.002)
                    self._send_signal.set()
        except Exception as e:
            self._stop_for_error(e)

    def _flush_batch(self, batch: list, ctxs: list) -> None:
        """Write one frame of complete packets.  A ctx-capable conn
        gets the per-EOF context list WITH the frame (Nones included:
        the receiver pops exactly one entry per completed message, so
        the list must stay aligned even when most sends carry no ctx)."""
        data = b"".join(struct.pack(">I", len(p)) + p for p in batch)
        w = self._write_with_ctx
        if w is not None:
            w(data, ctxs)
        else:
            self._conn.write(data)

    # -- receiving ---------------------------------------------------------
    def _recv_routine(self) -> None:
        buf = b""
        try:
            while self.is_running():
                data = self._conn.read()
                if data == b"":
                    raise MConnectionError("connection closed by peer")
                self._recv_monitor.update(len(data))
                self._recv_monitor.limit(len(data), self._recv_rate,
                                         block=True)
                buf += data
                while len(buf) >= 4:
                    (plen,) = struct.unpack_from(">I", buf)
                    if plen > MAX_PACKET_MSG_PAYLOAD_SIZE + 1024:
                        raise MConnectionError("oversized packet")
                    if len(buf) < 4 + plen:
                        break
                    payload, buf = buf[4:4 + plen], buf[4 + plen:]
                    self._handle_packet(payload)
        except Exception as e:
            self._stop_for_error(e)

    def _handle_packet(self, payload: bytes) -> None:
        kind, ch_id, eof, data = _unpack_packet(payload)
        if kind == "ping":
            self._pong_pending.set()
            self._send_signal.set()
            return
        if kind == "pong":
            self._pong_deadline = None
            return
        if kind == "ctx":
            # in-band trace context: applies to this channel's next
            # message EOF (the sender emits it immediately ahead)
            self._recv_pending_ctx[ch_id] = data
            return
        ch = self._channels.get(ch_id)
        if ch is None:
            raise MConnectionError(f"unknown channel {ch_id}")
        if self.metrics is not None:
            self.metrics.message_receive_bytes_total.labels(
                "%#x" % ch_id).add(4 + len(payload))
        msg = ch.recv_packet(eof, data)
        if msg is not None:
            pop = self._pop_recv_ctx
            if pop is not None:
                tctx = pop()
            else:
                tctx = self._recv_pending_ctx.pop(ch_id, None)
            if self._recv_takes_ctx:
                self._on_receive(ch_id, msg, tctx)
            else:
                self._on_receive(ch_id, msg)

    def _stop_for_error(self, e: Exception) -> None:
        if self.is_running():
            self.stop()
            if self._on_error is not None:
                self._on_error(e)

    def status(self) -> dict:
        return {
            "send": self._send_monitor.status(),
            "recv": self._recv_monitor.status(),
            "channels": {
                ch_id: {"recently_sent": ch.recently_sent}
                for ch_id, ch in self._channels.items()},
        }
