"""Decode CometBFT JSON-RPC responses into the port's types (the port's
copy of `cometbft_tpu.light.rpc_decode`).

The JSON shapes are CometBFT's /commit (rpc/core/blocks.go) and
/validators (rpc/core/consensus.go): base64 bytes, hex hashes, decimal
strings for integers, RFC3339 times.
"""

from __future__ import annotations

import base64

from ..crypto.encoding import make_pubkey
from ..types.block import (
    BlockID, Commit, CommitSig, Consensus, Header, PartSetHeader,
)
from ..types.timestamp import Timestamp
from ..types.validator_set import Validator
from .types import SignedHeader

_FLAGS = {"BLOCK_ID_FLAG_ABSENT": 1, "BLOCK_ID_FLAG_COMMIT": 2,
          "BLOCK_ID_FLAG_NIL": 3}

_KEY_TYPES = {
    "tendermint/PubKeyEd25519": "ed25519",
    "tendermint/PubKeySecp256k1": "secp256k1",
    "cometbft/PubKeyEd25519": "ed25519",
    "cometbft/PubKeySecp256k1": "secp256k1",
}


def _b64(s: str | None) -> bytes:
    return base64.b64decode(s) if s else b""


def _hex(s: str | None) -> bytes:
    return bytes.fromhex(s) if s else b""


def _int(v) -> int:
    return int(v) if v is not None else 0


def block_id_from_rpc(d: dict | None) -> BlockID:
    if not d:
        return BlockID()
    psh = d.get("parts") or d.get("part_set_header") or {}
    return BlockID(
        hash=_hex(d.get("hash")),
        part_set_header=PartSetHeader(_int(psh.get("total")),
                                      _hex(psh.get("hash"))))


def header_from_rpc(d: dict) -> Header:
    ver = d.get("version") or {}
    return Header(
        version=Consensus(_int(ver.get("block")), _int(ver.get("app"))),
        chain_id=d["chain_id"],
        height=_int(d["height"]),
        time=Timestamp.from_rfc3339(d["time"]),
        last_block_id=block_id_from_rpc(d.get("last_block_id")),
        last_commit_hash=_hex(d.get("last_commit_hash")),
        data_hash=_hex(d.get("data_hash")),
        validators_hash=_hex(d.get("validators_hash")),
        next_validators_hash=_hex(d.get("next_validators_hash")),
        consensus_hash=_hex(d.get("consensus_hash")),
        app_hash=_hex(d.get("app_hash")),
        last_results_hash=_hex(d.get("last_results_hash")),
        evidence_hash=_hex(d.get("evidence_hash")),
        proposer_address=_hex(d.get("proposer_address")))


def commit_from_rpc(d: dict) -> Commit:
    sigs = []
    for s in d.get("signatures", []):
        flag = s.get("block_id_flag")
        if isinstance(flag, str):
            flag = _FLAGS[flag] if flag in _FLAGS else _int(flag)
        ts = s.get("timestamp")
        sigs.append(CommitSig(
            block_id_flag=_int(flag),
            validator_address=_hex(s.get("validator_address")),
            timestamp=Timestamp.from_rfc3339(ts)
            if ts and not ts.startswith("0001-01-01") else Timestamp.zero(),
            signature=_b64(s.get("signature"))))
    return Commit(
        height=_int(d["height"]),
        round=_int(d.get("round")),
        block_id=block_id_from_rpc(d.get("block_id")),
        signatures=sigs)


def signed_header_from_rpc(d: dict) -> SignedHeader:
    return SignedHeader(header_from_rpc(d["header"]),
                        commit_from_rpc(d["commit"]))


def validators_from_rpc(items: list[dict]) -> list[Validator]:
    out = []
    for v in items:
        pk = v["pub_key"]
        if "type" in pk:
            key_type = _KEY_TYPES.get(pk["type"], pk["type"])
            data = _b64(pk["value"])
        else:  # the newer RPC's {"ed25519": "..."} shape
            key_type, data = next(iter(pk.items()))
            data = _b64(data)
        out.append(Validator(
            pub_key=make_pubkey(key_type, data),
            voting_power=_int(v.get("voting_power")),
            proposer_priority=_int(v.get("proposer_priority")),
            address=_hex(v.get("address"))))
    return out
