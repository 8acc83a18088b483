"""Canonical vote sign-bytes (the port's copy of the vote half of
`cometbft_tpu.types.canonical`).

These bytes are what validators sign — byte-for-byte compatibility with
CometBFT is consensus-critical.  CanonicalVote layout (CometBFT
proto/cometbft/types/v1/canonical.proto): type=1 varint, height=2
sfixed64, round=3 sfixed64, block_id=4 (nullable: omitted for nil votes),
timestamp=5 (always), chain_id=6; the result is length-delimited.
"""

from __future__ import annotations

import numpy as np

from ..libs import protowire as pw
from .timestamp import Timestamp

PRECOMMIT = 2


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
