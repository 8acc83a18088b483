"""PubKey <-> proto encoding for the port's key types (the port's copy of
`cometbft_tpu.crypto.encoding`).

The wire message is cometbft.crypto.v1.PublicKey, a oneof with
`bytes ed25519 = 1`, `bytes secp256k1 = 2` and `bytes bls12381 = 3`
(proto/cometbft/crypto/v1/keys.proto).  These bytes feed
SimpleValidator hashing (types/validator.go), so they are
consensus-critical; decoding turns a validator set read from the wire
(a light block, an RPC response) into the port's own key classes.
"""

from __future__ import annotations

from ..libs import protowire as pw

_FIELD_BY_TYPE = {"ed25519": 1, "secp256k1": 2, "bls12_381": 3}
_TYPE_BY_FIELD = {v: k for k, v in _FIELD_BY_TYPE.items()}


def pubkey_to_proto(pubkey) -> bytes:
    """Marshal a PubKey into PublicKey message bytes."""
    field = _FIELD_BY_TYPE.get(pubkey.type())
    if field is None:
        raise ValueError(f"unsupported pubkey type {pubkey.type()}")
    return pw.Writer().bytes_field(field, pubkey.bytes()).bytes()


def pubkey_from_proto(payload: bytes):
    """Unmarshal PublicKey message bytes into a PubKey object; a message
    with no known key field raises ValueError."""
    r = pw.Reader(payload)
    while not r.at_end():
        field, wire = r.read_tag()
        if wire == pw.BYTES and field in _TYPE_BY_FIELD:
            return make_pubkey(_TYPE_BY_FIELD[field], r.read_bytes())
        r.skip(wire)
    raise ValueError("empty PublicKey message")


def make_pubkey(key_type: str, data: bytes):
    if key_type == "ed25519":
        from . import ed25519
        return ed25519.PubKey(data)
    if key_type == "secp256k1":
        from . import secp256k1
        return secp256k1.PubKey(data)
    if key_type == "bls12_381":
        # the key needs only its bytes; verifying raises while the native
        # library is not built (bls12381.enabled())
        from . import bls12381
        return bls12381.PubKey(data)
    raise ValueError(f"unsupported pubkey type {key_type}")
