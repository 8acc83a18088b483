"""Blocksync wire messages (the port's copy of
`cometbft_tpu.blocksync.messages`; CometBFT
proto/cometbft/blocksync/v1/types.proto)."""

from __future__ import annotations

from dataclasses import dataclass

from ..libs import protowire as pw
from ..types.block import Block, ExtendedCommit


@dataclass
class BlockRequest:
    height: int = 0
    FIELD = 1

    def to_proto(self) -> bytes:
        return pw.Writer().int_field(1, self.height).bytes()

    @staticmethod
    def from_proto(p: bytes) -> "BlockRequest":
        return BlockRequest(_read_height(p))


@dataclass
class NoBlockResponse:
    height: int = 0
    FIELD = 2

    def to_proto(self) -> bytes:
        return pw.Writer().int_field(1, self.height).bytes()

    @staticmethod
    def from_proto(p: bytes) -> "NoBlockResponse":
        return NoBlockResponse(_read_height(p))


@dataclass
class BlockResponse:
    block: Block | None = None
    ext_commit: ExtendedCommit | None = None
    FIELD = 3

    def to_proto(self) -> bytes:
        w = pw.Writer()
        if self.block is not None:
            w.message_field(1, self.block.to_proto())
        if self.ext_commit is not None:
            w.message_field(2, self.ext_commit.to_proto())
        return w.bytes()

    @staticmethod
    def from_proto(p: bytes) -> "BlockResponse":
        r = pw.Reader(p)
        m = BlockResponse()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.block = Block.from_proto(r.read_bytes())
            elif f == 2 and w == pw.BYTES:
                m.ext_commit = ExtendedCommit.from_proto(r.read_bytes())
            else:
                r.skip(w)
        return m


@dataclass
class StatusRequest:
    FIELD = 4

    def to_proto(self) -> bytes:
        return b""

    @staticmethod
    def from_proto(p: bytes) -> "StatusRequest":
        return StatusRequest()


@dataclass
class StatusResponse:
    height: int = 0
    base: int = 0
    FIELD = 5

    def to_proto(self) -> bytes:
        return (pw.Writer().int_field(1, self.height)
                .int_field(2, self.base).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "StatusResponse":
        r = pw.Reader(p)
        m = StatusResponse()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.height = r.read_int()
            elif f == 2 and w == pw.VARINT:
                m.base = r.read_int()
            else:
                r.skip(w)
        return m


def _read_height(p: bytes) -> int:
    r = pw.Reader(p)
    h = 0
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1 and w == pw.VARINT:
            h = r.read_int()
        else:
            r.skip(w)
    return h


_TYPES = (BlockRequest, NoBlockResponse, BlockResponse, StatusRequest,
          StatusResponse)
_BY_FIELD = {cls.FIELD: cls for cls in _TYPES}


def wrap(msg) -> bytes:
    return pw.Writer().message_field(msg.FIELD, msg.to_proto()).bytes()


def wrap_block_response_bytes(block_bytes: bytes,
                              ext_commit=None) -> bytes:
    """The wrapped BlockResponse built straight from serialized block
    wire bytes — byte-identical to wrap(BlockResponse(block, ext))
    because block.to_proto() IS block_bytes.  The serve path uses this
    with BlockStore.load_block_bytes so a cache hit never decodes or
    re-encodes the block."""
    w = pw.Writer().message_field(1, block_bytes)
    if ext_commit is not None:
        w.message_field(2, ext_commit.to_proto())
    return (pw.Writer()
            .message_field(BlockResponse.FIELD, w.bytes()).bytes())


def unwrap(payload: bytes):
    r = pw.Reader(payload)
    while not r.at_end():
        f, w = r.read_tag()
        if w == pw.BYTES and f in _BY_FIELD:
            return _BY_FIELD[f].from_proto(r.read_bytes())
        r.skip(w)
    raise ValueError("empty blocksync Message")
