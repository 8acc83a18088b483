"""Node identity (the port's copy of `cometbft_tpu.p2p.key`; CometBFT
p2p/key.go).

ID = lowercase hex of the Ed25519 pubkey address; the key persists as
JSON, the private key in the amino envelope libs/tmjson.py writes.
"""

from __future__ import annotations

import json
import os

from ..crypto import ed25519
from ..libs import tmjson


def node_id_from_pubkey(pub_key) -> str:
    """p2p.PubKeyToID."""
    return pub_key.address().hex()


class NodeKey:
    def __init__(self, priv_key):
        self.priv_key = priv_key

    @property
    def id(self) -> str:
        return node_id_from_pubkey(self.priv_key.pub_key())

    def pub_key(self):
        return self.priv_key.pub_key()

    def sign(self, msg: bytes) -> bytes:
        return self.priv_key.sign(msg)

    def save_as(self, path: str) -> None:
        payload = json.dumps({"priv_key": tmjson.to_obj(self.priv_key)},
                             indent=2)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            f.write(payload)

    @staticmethod
    def load(path: str) -> "NodeKey":
        with open(path) as f:
            obj = json.load(f)
        priv = tmjson.from_obj(obj["priv_key"])
        if not isinstance(priv, ed25519.PrivKey):
            raise ValueError(f"{path}: not an ed25519 node key")
        return NodeKey(priv)

    @staticmethod
    def load_or_gen(path: str) -> "NodeKey":
        """p2p.LoadOrGenNodeKey."""
        if os.path.exists(path):
            return NodeKey.load(path)
        nk = NodeKey(ed25519.PrivKey.generate())
        nk.save_as(path)
        return nk
