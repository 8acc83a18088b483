"""Canonical sign-bytes (the port's copy of
`cometbft_tpu.types.canonical`), and the timestamp split privval uses.

These bytes are what validators sign — byte-for-byte compatibility with
CometBFT is consensus-critical.  Layouts from CometBFT
proto/cometbft/types/v1/canonical.proto:
- CanonicalVote: type=1 varint, height=2 sfixed64, round=3 sfixed64,
  block_id=4 (nullable: omitted for nil votes), timestamp=5 (always),
  chain_id=6.
- CanonicalProposal: type=1, height=2 sfixed64, round=3 sfixed64,
  pol_round=4 varint, block_id=5, timestamp=6, chain_id=7.
- CanonicalVoteExtension: extension=1, height=2 sfixed64,
  round=3 sfixed64, chain_id=4.
The result is length-delimited (varint size prefix).
"""

from __future__ import annotations

import numpy as np

from ..libs import protowire as pw
from .timestamp import Timestamp

PREVOTE = 1
PRECOMMIT = 2
PROPOSAL = 32


def canonical_block_id(block_id) -> bytes | None:
    """nil for zero BlockIDs (CometBFT types/canonical.go)."""
    if block_id.is_nil():
        return None
    psh = (pw.Writer().uvarint_field(1, block_id.part_set_header.total)
           .bytes_field(2, block_id.part_set_header.hash).bytes())
    return (pw.Writer().bytes_field(1, block_id.hash)
            .message_field(2, psh).bytes())


def vote_sign_bytes(chain_id: str, msg_type: int, height: int, round_: int,
                    block_id, timestamp: Timestamp) -> bytes:
    w = (pw.Writer()
         .int_field(1, msg_type)
         .sfixed64_field(2, height)
         .sfixed64_field(3, round_)
         .optional_message_field(4, canonical_block_id(block_id))
         .message_field(5, timestamp.to_proto())
         .string_field(6, chain_id))
    return pw.marshal_delimited(w.bytes())


def vote_sign_bytes_columnar(chain_id: str, msg_type: int, height: int,
                             round_: int, block_id,
                             timestamps) -> list[bytes]:
    """Whole-commit sign-bytes in one numpy splice: all rows differ ONLY
    in the timestamp field, so rows with the same timestamp wire length
    have identical framing at identical offsets.  Group by wire length,
    tile the constant framing once per group, and splice the timestamp
    bytes in as one (g, ts_len) block.  Byte-identical to
    vote_sign_bytes row by row.  Returns sign-bytes in input order."""
    head = (pw.Writer()
            .int_field(1, msg_type)
            .sfixed64_field(2, height)
            .sfixed64_field(3, round_)
            .optional_message_field(4, canonical_block_id(block_id))
            .bytes())
    tail = pw.Writer().string_field(6, chain_id).bytes()
    uv = pw.encode_uvarint

    ts_protos = [ts.to_proto() for ts in timestamps]
    groups: dict[int, list[int]] = {}
    for i, ts in enumerate(ts_protos):
        groups.setdefault(len(ts), []).append(i)

    out: list[bytes] = [b""] * len(ts_protos)
    for tl, idxs in groups.items():
        lenpfx = uv(tl)
        payload_len = len(head) + 1 + len(lenpfx) + tl + len(tail)
        prefix = uv(payload_len) + head + b"\x2a" + lenpfx
        poff = len(prefix)
        row_len = poff + tl + len(tail)
        g = len(idxs)
        mat = np.empty((g, row_len), dtype=np.uint8)
        mat[:, :poff] = np.frombuffer(prefix, dtype=np.uint8)
        if tl:
            mat[:, poff:poff + tl] = np.frombuffer(
                b"".join(ts_protos[i] for i in idxs),
                dtype=np.uint8).reshape(g, tl)
        if tail:
            mat[:, poff + tl:] = np.frombuffer(tail, dtype=np.uint8)
        rows = mat.tobytes()
        for j, i in enumerate(idxs):
            out[i] = rows[j * row_len:(j + 1) * row_len]
    return out


def proposal_sign_bytes(chain_id: str, height: int, round_: int,
                        pol_round: int, block_id,
                        timestamp: Timestamp) -> bytes:
    w = (pw.Writer()
         .int_field(1, PROPOSAL)
         .sfixed64_field(2, height)
         .sfixed64_field(3, round_)
         .int_field(4, pol_round)
         .optional_message_field(5, canonical_block_id(block_id))
         .message_field(6, timestamp.to_proto())
         .string_field(7, chain_id))
    return pw.marshal_delimited(w.bytes())


def vote_extension_sign_bytes(chain_id: str, height: int, round_: int,
                              extension: bytes) -> bytes:
    w = (pw.Writer()
         .bytes_field(1, extension)
         .sfixed64_field(2, height)
         .sfixed64_field(3, round_)
         .string_field(4, chain_id))
    return pw.marshal_delimited(w.bytes())


# field numbers of the timestamp in the canonical vote / proposal
VOTE_TIMESTAMP_FIELD = 5
PROPOSAL_TIMESTAMP_FIELD = 6


def split_timestamp(sign_bytes: bytes, ts_field: int
                    ) -> tuple[bytes, Timestamp]:
    """Strip the canonical timestamp field out of length-delimited
    sign-bytes, returning (remainder, timestamp). Used by privval to
    decide whether two sign requests differ only in timestamp
    (privval/file.go:442-480)."""
    payload, _ = pw.unmarshal_delimited(sign_bytes, 0)
    r = pw.Reader(payload)
    out = pw.Writer()
    ts = Timestamp.zero()
    while not r.at_end():
        f, w = r.read_tag()
        if f == ts_field and w == pw.BYTES:
            ts = Timestamp.from_proto(r.read_bytes())
            continue
        if w == pw.VARINT:
            out.tag(f, w).raw(pw.encode_uvarint(r.read_uvarint()))
        elif w == pw.FIXED64:
            out.tag(f, w).raw(r.buf[r.pos:r.pos + 8])
            r.pos += 8
        elif w == pw.BYTES:
            b = r.read_bytes()
            out.tag(f, w).raw(pw.encode_uvarint(len(b))).raw(b)
        else:
            r.skip(w)
    return out.bytes(), ts
