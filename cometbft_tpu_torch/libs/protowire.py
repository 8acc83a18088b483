"""Minimal protobuf wire codec: the port's copy of
`cometbft_tpu.libs.protowire`, its writer for canonical sign-bytes and
its reader for the vote path's messages (votes, commits, bit arrays,
evidence).  Gogoproto conventions reproduced (byte parity with
CometBFT's generated marshallers):
- proto3 scalar/enum/bytes/string fields with zero values are omitted;
- `nullable=false` embedded messages are ALWAYS emitted, even when empty;
- fields are emitted in ascending tag order;
- negative int32/int64 varints sign-extend to 10 bytes;
- sfixed64 is 8-byte little-endian two's complement.
"""

from __future__ import annotations

import struct

_U64 = (1 << 64) - 1

MASK64 = (1 << 64) - 1

# wire types
VARINT = 0
FIXED64 = 1
BYTES = 2
FIXED32 = 5


def encode_uvarint(v: int) -> bytes:
    if v < 0:
        raise ValueError("uvarint must be non-negative")
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_uvarint(buf: bytes, pos: int = 0) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            if result > _U64:
                raise ValueError("varint overflows uint64")
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


class Writer:
    """Appends proto fields in tag order; caller keeps tags ascending."""

    __slots__ = ("_parts",)

    def __init__(self):
        self._parts: list[bytes] = []

    def raw(self, b: bytes) -> "Writer":
        self._parts.append(b)
        return self

    def tag(self, field: int, wire: int) -> "Writer":
        self._parts.append(encode_uvarint((field << 3) | wire))
        return self

    def uvarint_field(self, field: int, v: int) -> "Writer":
        if v != 0:
            self.tag(field, VARINT).raw(encode_uvarint(v))
        return self

    def int_field(self, field: int, v: int) -> "Writer":
        """int32/int64/enum: negative encodes as 10-byte two's complement."""
        if v != 0:
            self.tag(field, VARINT).raw(encode_uvarint(v & _U64))
        return self

    def sfixed64_field(self, field: int, v: int) -> "Writer":
        if v != 0:
            self.tag(field, FIXED64).raw(struct.pack("<q", v))
        return self

    def bytes_field(self, field: int, v: bytes) -> "Writer":
        if v:
            self.tag(field, BYTES).raw(encode_uvarint(len(v))).raw(v)
        return self

    def string_field(self, field: int, v: str) -> "Writer":
        return self.bytes_field(field, v.encode("utf-8"))

    def packed_uint64_field(self, field: int, vals) -> "Writer":
        payload = b"".join(encode_uvarint(v & MASK64) for v in vals)
        return self.bytes_field(field, payload)

    def message_field(self, field: int, payload: bytes) -> "Writer":
        """Embedded message, gogo nullable=false: always emitted."""
        self.tag(field, BYTES).raw(encode_uvarint(len(payload))).raw(payload)
        return self

    def optional_message_field(self, field: int,
                               payload: bytes | None) -> "Writer":
        """Embedded message behind a pointer: omitted when None."""
        if payload is not None:
            self.message_field(field, payload)
        return self

    def bytes(self) -> bytes:  # noqa: A003 - mirrors bytes() of buffers
        return b"".join(self._parts)


def sint_from_uvarint(v: int) -> int:
    """Interpret a uint64 varint as two's-complement int64."""
    return v - (1 << 64) if v >= (1 << 63) else v


class Reader:
    """Field-by-field reader over one message's payload."""

    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf: bytes, pos: int = 0, end: int | None = None):
        self.buf = buf
        self.pos = pos
        self.end = len(buf) if end is None else end

    def at_end(self) -> bool:
        return self.pos >= self.end

    def read_tag(self) -> tuple[int, int]:
        key = self.read_uvarint()
        return key >> 3, key & 0x7

    def read_uvarint(self) -> int:
        v, pos = decode_uvarint(self.buf[:self.end], self.pos)
        self.pos = pos
        return v

    def read_int(self) -> int:
        return sint_from_uvarint(self.read_uvarint())

    def read_sfixed64(self) -> int:
        if self.pos + 8 > self.end:
            raise ValueError("truncated sfixed64 field")
        v = struct.unpack_from("<q", self.buf, self.pos)[0]
        self.pos += 8
        return v

    def read_fixed32(self) -> int:
        if self.pos + 4 > self.end:
            raise ValueError("truncated fixed32 field")
        v = struct.unpack_from("<I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def read_bytes(self) -> bytes:
        n = self.read_uvarint()
        if self.pos + n > self.end:
            raise ValueError("truncated bytes field")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def read_string(self) -> str:
        return self.read_bytes().decode("utf-8")

    def read_packed_uint64(self) -> list[int]:
        payload = self.read_bytes()
        vals, pos = [], 0
        while pos < len(payload):
            v, pos = decode_uvarint(payload, pos)
            vals.append(v)
        return vals

    def sub_reader(self) -> "Reader":
        n = self.read_uvarint()
        if self.pos + n > self.end:
            raise ValueError("truncated message field")
        r = Reader(self.buf, self.pos, self.pos + n)
        self.pos += n
        return r

    def skip(self, wire: int) -> None:
        if wire == VARINT:
            self.read_uvarint()
        elif wire == FIXED64:
            self.read_sfixed64()
        elif wire == BYTES:
            self.read_bytes()
        elif wire == FIXED32:
            self.read_fixed32()
        else:
            raise ValueError(f"unknown wire type {wire}")


# -- length-delimited framing (libs/protoio) --------------------------------

def marshal_delimited(payload: bytes) -> bytes:
    """varint(len) || payload — the framing of SignBytes (CometBFT
    types/vote.go, libs/protoio/writer.go)."""
    return encode_uvarint(len(payload)) + payload


def unmarshal_delimited(buf: bytes, pos: int = 0) -> tuple[bytes, int]:
    n, pos = decode_uvarint(buf, pos)
    if pos + n > len(buf):
        raise ValueError("truncated delimited message")
    return buf[pos:pos + n], pos + n


def try_unmarshal_delimited(buf: bytes, pos: int = 0,
                            max_frame: int = 256 * 1024 * 1024):
    """Streaming-friendly framing: returns (payload, end_pos) for a whole
    frame, None when more bytes are needed, and raises ValueError for a
    genuinely corrupt stream (invalid/oversized length varint) — the
    distinction socket read loops need to tell 'wait' from 'tear down'."""
    try:
        n, body = decode_uvarint(buf, pos)
    except ValueError as e:
        if "truncated" in str(e) and len(buf) - pos < 10:
            return None  # varint may still be arriving
        raise
    if n > max_frame:
        raise ValueError(f"frame length {n} exceeds cap {max_frame}")
    if body + n > len(buf):
        return None
    return buf[body:body + n], body + n


# -- google.protobuf.Timestamp ----------------------------------------------

def encode_timestamp(seconds: int, nanos: int) -> bytes:
    """google.protobuf.Timestamp payload: int64 seconds = 1, int32 nanos = 2."""
    return Writer().int_field(1, seconds).int_field(2, nanos).bytes()


def decode_timestamp(payload: bytes) -> tuple[int, int]:
    r = Reader(payload)
    seconds = nanos = 0
    while not r.at_end():
        field, wire = r.read_tag()
        if field == 1 and wire == VARINT:
            seconds = r.read_int()
        elif field == 2 and wire == VARINT:
            nanos = r.read_int()
        else:
            r.skip(wire)
    return seconds, nanos
