"""PubKey -> proto encoding for the port's key types, the part of
`cometbft_tpu.crypto.encoding` that validator-set hashing needs.

The wire message is cometbft.crypto.v1.PublicKey, a oneof with
`bytes ed25519 = 1` and `bytes secp256k1 = 2`
(proto/cometbft/crypto/v1/keys.proto).  These bytes
feed SimpleValidator hashing (types/validator.go), so they are
consensus-critical.
"""

from __future__ import annotations

from ..libs import protowire as pw

_FIELD_BY_TYPE = {"ed25519": 1, "secp256k1": 2}


def pubkey_to_proto(pubkey) -> bytes:
    """Marshal a PubKey into PublicKey message bytes."""
    field = _FIELD_BY_TYPE.get(pubkey.type())
    if field is None:
        raise ValueError(f"unsupported pubkey type {pubkey.type()}")
    return pw.Writer().bytes_field(field, pubkey.bytes()).bytes()
