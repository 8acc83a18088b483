"""Protobuf wire encoders for canonical sign-bytes.

The port's copy of the encoding half of `cometbft_tpu.libs.protowire`,
trimmed to what commit verification signs over.  Gogoproto conventions
reproduced (byte parity with CometBFT's generated marshallers):
- proto3 scalar/enum/bytes/string fields with zero values are omitted;
- `nullable=false` embedded messages are ALWAYS emitted, even when empty;
- fields are emitted in ascending tag order;
- negative int32/int64 varints sign-extend to 10 bytes;
- sfixed64 is 8-byte little-endian two's complement.
"""

from __future__ import annotations

import struct

_U64 = (1 << 64) - 1

# wire types
VARINT = 0
FIXED64 = 1
BYTES = 2


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


def marshal_delimited(payload: bytes) -> bytes:
    """varint(len) || payload — the framing of SignBytes (CometBFT
    types/vote.go, libs/protoio/writer.go)."""
    return encode_uvarint(len(payload)) + payload


def encode_timestamp(seconds: int, nanos: int) -> bytes:
    """google.protobuf.Timestamp payload: int64 seconds = 1, int32 nanos = 2."""
    return Writer().int_field(1, seconds).int_field(2, nanos).bytes()
