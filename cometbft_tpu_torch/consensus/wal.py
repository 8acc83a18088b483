"""Consensus write-ahead log (the port's copy of
`cometbft_tpu.consensus.wal`; CometBFT internal/consensus/wal.go).

Every message is written to the WAL BEFORE it is processed, so a crash
at any point can be replayed deterministically. Framing per record
(wal.go WALEncoder):

    crc32c(payload) u32 BE | len(payload) u32 BE | payload

payload = TimedWALMessage proto {time:1, msg:2} with msg a nested
WALMessage oneof (matching wal.proto):
    1 EventRoundState {height, round, step}
    2 MsgInfo        {peer_id, opaque consensus-msg proto}
    3 TimeoutInfo    {duration_ns, height, round, step}
    4 EndHeight      {height}

EndHeight(H) is fsync'd after block H commits (state.go:1905); replay
for height H+1 starts just after it. Decode tolerates a torn tail
(truncated final record) but surfaces mid-log corruption as
DataCorruptionError, matching CometBFT's crash-recovery contract.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..libs import protowire as pw
from ..libs.crc32c import crc32c
from ..libs.autofile import Group
from ..types.timestamp import Timestamp

MAX_MSG_SIZE = 1024 * 1024  # wal.go maxMsgSizeBytes


class DataCorruptionError(Exception):
    pass


@dataclass
class EventRoundState:
    height: int = 0
    round: int = 0
    step: str = ""

    TAG = 1

    def to_proto(self) -> bytes:
        return (pw.Writer().int_field(1, self.height)
                .int_field(2, self.round).string_field(3, self.step).bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "EventRoundState":
        r = pw.Reader(payload)
        m = EventRoundState()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.height = r.read_int()
            elif f == 2 and w == pw.VARINT:
                m.round = r.read_int()
            elif f == 3 and w == pw.BYTES:
                m.step = r.read_string()
            else:
                r.skip(w)
        return m


@dataclass
class MsgInfo:
    """A consensus message (proposal/block-part/vote) from a peer;
    empty peer_id means internal."""
    peer_id: str = ""
    msg_bytes: bytes = b""

    TAG = 2

    def to_proto(self) -> bytes:
        return (pw.Writer().string_field(1, self.peer_id)
                .bytes_field(2, self.msg_bytes).bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "MsgInfo":
        r = pw.Reader(payload)
        m = MsgInfo()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.peer_id = r.read_string()
            elif f == 2 and w == pw.BYTES:
                m.msg_bytes = r.read_bytes()
            else:
                r.skip(w)
        return m


@dataclass
class TimeoutInfo:
    duration_ns: int = 0
    height: int = 0
    round: int = 0
    step: int = 0

    TAG = 3

    def to_proto(self) -> bytes:
        return (pw.Writer().int_field(1, self.duration_ns)
                .int_field(2, self.height).int_field(3, self.round)
                .int_field(4, self.step).bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "TimeoutInfo":
        r = pw.Reader(payload)
        m = TimeoutInfo()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.duration_ns = r.read_int()
            elif f == 2 and w == pw.VARINT:
                m.height = r.read_int()
            elif f == 3 and w == pw.VARINT:
                m.round = r.read_int()
            elif f == 4 and w == pw.VARINT:
                m.step = r.read_int()
            else:
                r.skip(w)
        return m


@dataclass
class EndHeightMessage:
    height: int = 0

    TAG = 4

    def to_proto(self) -> bytes:
        return pw.Writer().int_field(1, self.height).bytes()

    @staticmethod
    def from_proto(payload: bytes) -> "EndHeightMessage":
        r = pw.Reader(payload)
        m = EndHeightMessage()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.height = r.read_int()
            else:
                r.skip(w)
        return m


_TYPES = {cls.TAG: cls for cls in
          (EventRoundState, MsgInfo, TimeoutInfo, EndHeightMessage)}

WALMessage = object  # union alias for type hints


@dataclass
class TimedWALMessage:
    time: Timestamp = field(default_factory=Timestamp.zero)
    msg: object = None

    def to_proto(self) -> bytes:
        wal_msg = pw.Writer().message_field(
            self.msg.TAG, self.msg.to_proto()).bytes()
        return (pw.Writer().message_field(1, self.time.to_proto())
                .message_field(2, wal_msg).bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "TimedWALMessage":
        r = pw.Reader(payload)
        t, msg = Timestamp.zero(), None
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                t = Timestamp.from_proto(r.read_bytes())
            elif f == 2 and w == pw.BYTES:
                inner = pw.Reader(r.read_bytes())
                while not inner.at_end():
                    fi, wi = inner.read_tag()
                    if wi == pw.BYTES and fi in _TYPES:
                        msg = _TYPES[fi].from_proto(inner.read_bytes())
                    else:
                        inner.skip(wi)
            else:
                r.skip(w)
        if msg is None:
            raise DataCorruptionError("TimedWALMessage without payload")
        return TimedWALMessage(t, msg)


def _encode_record(payload: bytes) -> bytes:
    return struct.pack(">II", crc32c(payload), len(payload)) + payload


def decode_records(buf: bytes, tolerate_torn_tail: bool = True):
    """Yield TimedWALMessage records; raise DataCorruptionError on a
    mid-log CRC mismatch, silently stop on a truncated tail."""
    pos = 0
    n = len(buf)
    while pos < n:
        if pos + 8 > n:
            if tolerate_torn_tail:
                return
            raise DataCorruptionError("truncated record header")
        crc, length = struct.unpack_from(">II", buf, pos)
        if length > MAX_MSG_SIZE:
            raise DataCorruptionError(f"record too big: {length}")
        if pos + 8 + length > n:
            if tolerate_torn_tail:
                return
            raise DataCorruptionError("truncated record body")
        payload = buf[pos + 8:pos + 8 + length]
        if crc32c(payload) != crc:
            raise DataCorruptionError(f"crc mismatch at offset {pos}")
        yield TimedWALMessage.from_proto(payload)
        pos += 8 + length


def _valid_prefix_len(buf: bytes) -> int:
    """Byte length of the longest prefix of whole, CRC-valid records.

    Used to repair the head file after a crash: anything past this point
    is a torn or corrupt tail that must be truncated BEFORE appending,
    or every later replay would hit DataCorruptionError mid-log."""
    pos = 0
    n = len(buf)
    while pos + 8 <= n:
        crc, length = struct.unpack_from(">II", buf, pos)
        if length > MAX_MSG_SIZE or pos + 8 + length > n:
            break
        payload = buf[pos + 8:pos + 8 + length]
        if crc32c(payload) != crc:
            break
        try:
            TimedWALMessage.from_proto(payload)
        except Exception:  # noqa: BLE001 - undecodable = corrupt tail
            break
        pos += 8 + length
    return pos


class WAL:
    """BaseWAL analog over an autofile Group.

    On open, the head chunk is scanned and any torn/corrupt tail from a
    crash mid-write is truncated so new records append after the last
    whole record.  When the head is empty or missing, the NEWEST rolled
    chunk gets the same scan: a crash inside rotate_file (after the
    rename, before the write that would have populated the new head —
    or with the renamed file's tail torn because the fsync never hit
    the platter) leaves the torn record in the rolled chunk instead,
    and replay() concatenates chunks — so appending fresh records after
    an unrepaired torn rolled tail would turn a tolerable torn-tail
    into mid-log corruption that fails every later replay."""

    def __init__(self, head_path: str, **group_kwargs):
        self._repair_head(head_path)
        self._group = Group(head_path, **group_kwargs)

    @staticmethod
    def _repair_tail_of(path: str) -> None:
        try:
            with open(path, "rb") as f:
                buf = f.read()
        except FileNotFoundError:
            return
        good = _valid_prefix_len(buf)
        if good < len(buf):
            with open(path, "r+b") as f:
                f.truncate(good)

    @classmethod
    def _repair_head(cls, head_path: str) -> None:
        import os
        import re

        cls._repair_tail_of(head_path)
        try:
            if os.path.getsize(head_path) > 0:
                return
        except OSError:
            pass
        # head empty/missing: the last write before the crash landed in
        # the just-rotated chunk — repair the newest one too
        d = os.path.dirname(head_path) or "."
        base = os.path.basename(head_path)
        pat = re.compile(re.escape(base) + r"\.(\d{3,})$")
        try:
            names = os.listdir(d)
        except OSError:
            return
        indexes = [int(m.group(1)) for m in map(pat.match, names) if m]
        if indexes:
            cls._repair_tail_of(os.path.join(
                d, f"{base}.{max(indexes):03d}"))

    def write(self, msg) -> None:
        """Buffered write (wal.go Write: internal msgs use WriteSync)."""
        rec = TimedWALMessage(Timestamp.now(), msg)
        self._group.write(_encode_record(rec.to_proto()))

    def write_sync(self, msg) -> None:
        self.write(msg)
        self._group.flush_and_sync()

    def flush_and_sync(self) -> None:
        self._group.flush_and_sync()

    def maybe_rotate(self) -> None:
        self._group.maybe_rotate()

    def replay(self):
        """All decodable records, oldest first."""
        return list(decode_records(self._group.read_all()))

    def search_for_end_height(self, height: int):
        """Messages recorded AFTER EndHeight(height) — i.e. the partial
        progress of height+1 to replay (wal.go SearchForEndHeight).
        Returns (found, msgs).

        Scans chunk files newest->oldest so a full multi-GiB group never
        has to be decoded: the marker is almost always near the tail."""
        self._group.flush()
        paths = self._group.chunk_paths()
        tail_msgs: list[TimedWALMessage] = []
        for p in reversed(paths):
            try:
                with open(p, "rb") as f:
                    buf = f.read()
            except FileNotFoundError:
                continue
            msgs = list(decode_records(buf))
            for i in range(len(msgs) - 1, -1, -1):
                m = msgs[i].msg
                if isinstance(m, EndHeightMessage) and m.height == height:
                    return True, msgs[i + 1:] + tail_msgs
            tail_msgs = msgs + tail_msgs
        if height == 0:
            # no EndHeight(0) is ever written: the WAL's beginning IS the
            # height-0 marker, so the whole log is the replay tail
            return True, tail_msgs
        return False, []

    def repair(self) -> bool:
        """Repair mid-log corruption: back up every chunk, then truncate
        the group at the first corrupt record (CometBFT backs up and
        rewrites the valid prefix, consensus/wal.go corruption handling).
        Returns True if anything was changed."""
        import os
        import shutil

        self._group.flush()
        changed = False
        paths = self._group.chunk_paths()
        for i, p in enumerate(paths):
            try:
                with open(p, "rb") as f:
                    buf = f.read()
            except FileNotFoundError:
                continue
            good = _valid_prefix_len(buf)
            if good == len(buf):
                continue
            shutil.copyfile(p, p + ".corrupt")
            with open(p, "r+b") as f:
                f.truncate(good)
            # everything after the corruption point is unusable
            for later in paths[i + 1:]:
                try:
                    shutil.move(later, later + ".corrupt")
                except FileNotFoundError:
                    pass
            changed = True
            break
        if changed:
            self._group.reopen()
        return changed

    def close(self) -> None:
        self._group.close()
