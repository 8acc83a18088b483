"""Amino-compatible JSON with a type registry (the port's copy of
`cometbft_tpu.libs.tmjson`; CometBFT libs/json/).

Registered types marshal as {"type": "<amino name>", "value": <payload>}
— the envelope CometBFT uses for keys in genesis docs, priv_validator
files, and RPC results.  The registry covers the key types (public and
private, all supported curves) and the evidence types; `marshal` falls
through to plain JSON for unregistered values the way CometBFT
does for types without a registered name.
"""

from __future__ import annotations

import base64
import json
from typing import Callable

_BY_NAME: dict[str, Callable[[object], object]] = {}
_BY_TYPE: dict[type, tuple[str, Callable[[object], object]]] = {}


def register(cls: type, name: str,
             encode: Callable[[object], object],
             decode: Callable[[object], object]) -> None:
    """libs/json RegisterType."""
    if name in _BY_NAME:
        raise ValueError(f"amino name {name!r} already registered")
    _BY_NAME[name] = decode
    _BY_TYPE[cls] = (name, encode)


def name_of(obj) -> str | None:
    ent = _BY_TYPE.get(type(obj))
    return ent[0] if ent else None


def to_obj(value):
    """Value -> JSON-able object, wrapping registered types."""
    ent = _BY_TYPE.get(type(value))
    if ent is not None:
        name, encode = ent
        return {"type": name, "value": encode(value)}
    if isinstance(value, (list, tuple)):
        return [to_obj(v) for v in value]
    if isinstance(value, dict):
        return {k: to_obj(v) for k, v in value.items()}
    if isinstance(value, bytes):
        return base64.b64encode(value).decode()
    return value


def from_obj(obj):
    """JSON object -> value, unwrapping registered type envelopes."""
    if isinstance(obj, dict):
        if set(obj) == {"type", "value"} and obj["type"] in _BY_NAME:
            return _BY_NAME[obj["type"]](obj["value"])
        return {k: from_obj(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [from_obj(v) for v in obj]
    return obj


def marshal(value, indent=None) -> str:
    return json.dumps(to_obj(value), indent=indent)


def unmarshal(text: str):
    return from_obj(json.loads(text))


# ---------------------------------------------------------------------------
# standard registrations (CometBFT libs/json/structs.go + crypto pkgs)
# ---------------------------------------------------------------------------

def _key_codec(cls):
    return (lambda k: base64.b64encode(k.bytes()).decode(),
            lambda v: cls(base64.b64decode(v)))


def _register_defaults() -> None:
    from ..crypto import ed25519, secp256k1, sr25519

    for mod, pub_name, priv_name in (
            (ed25519, "tendermint/PubKeyEd25519",
             "tendermint/PrivKeyEd25519"),
            (secp256k1, "tendermint/PubKeySecp256k1",
             "tendermint/PrivKeySecp256k1"),
            (sr25519, "tendermint/PubKeySr25519",
             "tendermint/PrivKeySr25519")):
        enc, dec = _key_codec(mod.PubKey)
        register(mod.PubKey, pub_name, enc, dec)
        enc, dec = _key_codec(mod.PrivKey)
        register(mod.PrivKey, priv_name, enc, dec)

    from ..types.evidence import (DuplicateVoteEvidence,
                                  LightClientAttackEvidence,
                                  evidence_from_proto_wrapped,
                                  evidence_to_proto_wrapped)

    def _ev_codec(cls, name):
        register(
            cls, name,
            lambda e: base64.b64encode(
                evidence_to_proto_wrapped(e)).decode(),
            lambda v: evidence_from_proto_wrapped(base64.b64decode(v)))

    _ev_codec(DuplicateVoteEvidence, "tendermint/DuplicateVoteEvidence")
    _ev_codec(LightClientAttackEvidence,
              "tendermint/LightClientAttackEvidence")


_register_defaults()
