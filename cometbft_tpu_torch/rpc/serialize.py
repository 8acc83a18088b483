"""Serialize core types to CometBFT-compatible RPC JSON (the port's copy
of the encoders of `cometbft_tpu.rpc.serialize` that the lightserve
payload codec uses): hex hashes, base64 byte blobs, decimal-string
int64s, RFC3339 times.  The output is byte for byte the JAX package's;
light/rpc_decode.py parses these shapes.
"""

from __future__ import annotations

import base64

_FLAG_NAMES = {1: "BLOCK_ID_FLAG_ABSENT", 2: "BLOCK_ID_FLAG_COMMIT",
               3: "BLOCK_ID_FLAG_NIL"}


def _key_type_name(pubkey) -> str:
    from ..libs import tmjson
    return tmjson.name_of(pubkey) or "tendermint/PubKeyEd25519"


def b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def hex_upper(b: bytes) -> str:
    return b.hex().upper()


def block_id_json(bid) -> dict:
    return {
        "hash": hex_upper(bid.hash),
        "parts": {
            "total": bid.part_set_header.total,
            "hash": hex_upper(bid.part_set_header.hash),
        },
    }


def header_json(h) -> dict:
    return {
        "version": {"block": str(h.version.block),
                    "app": str(h.version.app)},
        "chain_id": h.chain_id,
        "height": str(h.height),
        "time": h.time.rfc3339(),
        "last_block_id": block_id_json(h.last_block_id),
        "last_commit_hash": hex_upper(h.last_commit_hash),
        "data_hash": hex_upper(h.data_hash),
        "validators_hash": hex_upper(h.validators_hash),
        "next_validators_hash": hex_upper(h.next_validators_hash),
        "consensus_hash": hex_upper(h.consensus_hash),
        "app_hash": hex_upper(h.app_hash),
        "last_results_hash": hex_upper(h.last_results_hash),
        "evidence_hash": hex_upper(h.evidence_hash),
        "proposer_address": hex_upper(h.proposer_address),
    }


def commit_sig_json(s) -> dict:
    return {
        "block_id_flag": _FLAG_NAMES.get(s.block_id_flag,
                                         str(s.block_id_flag)),
        "validator_address": hex_upper(s.validator_address),
        "timestamp": s.timestamp.rfc3339() if not s.timestamp.is_zero()
        else "0001-01-01T00:00:00Z",
        "signature": b64(s.signature) if s.signature else None,
    }


def commit_json(c) -> dict:
    return {
        "height": str(c.height),
        "round": c.round,
        "block_id": block_id_json(c.block_id),
        "signatures": [commit_sig_json(s) for s in c.signatures],
    }


def validator_json(v) -> dict:
    return {
        "address": hex_upper(v.address),
        "pub_key": {
            "type": _key_type_name(v.pub_key),
            "value": b64(v.pub_key.bytes()),
        },
        "voting_power": str(v.voting_power),
        "proposer_priority": str(v.proposer_priority),
    }
