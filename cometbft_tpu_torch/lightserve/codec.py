"""Serve-payload wire format and the client-side decode / verify pair
(the port's copy of `cometbft_tpu.lightserve.codec`).

A lightserve payload is one height's LightBlock as canonical JSON
(sorted keys, no whitespace): the signed header and the validator set
in exactly the shapes rpc/serialize.py emits, so the bytes double as the
``light_sync`` RPC result.  Canonical encoding is what makes the
coalescing A/B meaningful: two arms serving the same chain must produce
bit-identical blobs.

``verify_payload`` is the fleet's client: it rebuilds the Commit and
ValidatorSet from the received wire bytes (not from the server's
objects) and runs the full ``verify_commit`` on `device`.
"""

from __future__ import annotations

import base64
import json

from ..libs import tmjson
from ..light.rpc_decode import block_id_from_rpc
from ..rpc import serialize as ser
from ..types import validation
from ..types.block import Commit, CommitSig
from ..types.timestamp import Timestamp
from ..types.validator_set import Validator, ValidatorSet

_FLAGS = {"BLOCK_ID_FLAG_ABSENT": 1, "BLOCK_ID_FLAG_COMMIT": 2,
          "BLOCK_ID_FLAG_NIL": 3}


def encode_payload(height: int, header, commit, vals) -> bytes:
    doc = {
        "height": str(height),
        "signed_header": {
            "header": ser.header_json(header),
            "commit": ser.commit_json(commit),
        },
        "validator_set": {
            "validators": [ser.validator_json(v)
                           for v in vals.validators],
            "total_voting_power": str(vals.total_voting_power()),
        },
    }
    return json.dumps(doc, sort_keys=True,
                      separators=(",", ":")).encode()


def decode_payload(blob: bytes) -> dict:
    return json.loads(blob)


def commit_from_json(d: dict) -> Commit:
    """The served commit back as a Commit.  Unlike light/rpc_decode's
    commit_from_rpc, a zero timestamp's "0001-01-01T00:00:00Z" is parsed
    as the instant it names, as the JAX package's codec does."""
    sigs = []
    for s in d["signatures"]:
        flag = _FLAGS.get(s["block_id_flag"])
        if flag is None:
            flag = int(s["block_id_flag"])
        sig = base64.b64decode(s["signature"]) if s["signature"] else b""
        sigs.append(CommitSig(
            block_id_flag=flag,
            validator_address=bytes.fromhex(s["validator_address"]),
            timestamp=Timestamp.from_rfc3339(s["timestamp"]),
            signature=sig))
    return Commit(int(d["height"]), int(d["round"]),
                  block_id_from_rpc(d["block_id"]), sigs)


def validator_set_from_json(d: dict) -> ValidatorSet:
    vals = []
    for v in d["validators"]:
        vals.append(Validator(
            pub_key=tmjson.from_obj(v["pub_key"]),
            voting_power=int(v["voting_power"]),
            proposer_priority=int(v["proposer_priority"]),
            address=bytes.fromhex(v["address"])))
    return ValidatorSet.from_validated(vals)


def verify_payload(chain_id: str, blob: bytes, device="cuda") -> dict:
    """Decode one served payload and verify it the way a receiving light
    client would: structural consistency, then the full
    ``verify_commit`` (+2/3 power, every signature checked, on
    `device`) over the rebuilt commit and validator set.  Raises on any
    failure; returns the decoded document."""
    doc = decode_payload(blob)
    height = int(doc["height"])
    header = doc["signed_header"]["header"]
    commit = commit_from_json(doc["signed_header"]["commit"])
    vals = validator_set_from_json(doc["validator_set"])
    if int(header["height"]) != height or commit.height != height:
        raise validation.CommitVerificationError(
            f"payload height mismatch: payload {height}, header "
            f"{header['height']}, commit {commit.height}")
    if header["chain_id"] != chain_id:
        raise validation.CommitVerificationError(
            f"payload chain {header['chain_id']!r} != {chain_id!r}")
    validation.verify_commit(chain_id, vals, commit.block_id, height,
                             commit, device=device)
    return doc
