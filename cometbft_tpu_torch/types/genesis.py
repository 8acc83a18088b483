"""GenesisDoc: the chain's trusted starting point (the port's copy of
`cometbft_tpu.types.genesis`; CometBFT types/genesis.go).

JSON layout is interop-compatible with CometBFT's genesis.json: amino
type tags for pubkeys ("tendermint/PubKeyEd25519" + base64), stringified
int64s, hex app hash.
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field

from ..crypto.hash import sum_sha256
from .params import (BlockParams, ConsensusParams, EvidenceParams,
                     FeatureParams, SynchronyParams, ValidatorParams,
                     VersionParams)
from .timestamp import Timestamp
from .validator_set import Validator

MAX_CHAIN_ID_LEN = 50  # types/genesis.go MaxChainIDLen

# amino type names of the key types a genesis file may hold (the JAX
# package's libs/tmjson registry, which the port does not carry)
_AMINO_PUBKEY = {"ed25519": "tendermint/PubKeyEd25519",
                 "secp256k1": "tendermint/PubKeySecp256k1",
                 "sr25519": "tendermint/PubKeySr25519"}
_PUBKEY_TYPE = {v: k for k, v in _AMINO_PUBKEY.items()}


def pubkey_to_json(pubkey) -> dict:
    """Amino envelope {"type": name, "value": base64 key bytes}."""
    name = _AMINO_PUBKEY.get(getattr(pubkey, "type", lambda: None)())
    if name is None:
        raise ValueError(
            f"pubkey type {type(pubkey).__name__} not registered")
    return {"type": name,
            "value": base64.b64encode(pubkey.bytes()).decode()}


def pubkey_from_json(obj: dict):
    key_type = _PUBKEY_TYPE.get(obj.get("type")) \
        if isinstance(obj, dict) and set(obj) == {"type", "value"} else None
    if key_type is None:
        raise ValueError(f"unknown pubkey json type {obj.get('type')!r}")
    data = base64.b64decode(obj["value"])
    if key_type == "sr25519":
        from ..crypto import sr25519
        return sr25519.PubKey(data)
    from ..crypto.encoding import make_pubkey
    return make_pubkey(key_type, data)


@dataclass
class GenesisValidator:
    pub_key: object
    power: int
    name: str = ""
    address: bytes = b""

    def __post_init__(self):
        if not self.address and self.pub_key is not None:
            self.address = self.pub_key.address()

    def to_validator(self) -> Validator:
        return Validator(self.pub_key, self.power)


def _params_to_json(p: ConsensusParams) -> dict:
    return {
        "block": {"max_bytes": str(p.block.max_bytes),
                  "max_gas": str(p.block.max_gas)},
        "evidence": {
            "max_age_num_blocks": str(p.evidence.max_age_num_blocks),
            "max_age_duration": str(p.evidence.max_age_duration_ns),
            "max_bytes": str(p.evidence.max_bytes)},
        "validator": {"pub_key_types": list(p.validator.pub_key_types)},
        "version": {"app": str(p.version.app)},
        "synchrony": {"precision": str(p.synchrony.precision_ns),
                      "message_delay": str(p.synchrony.message_delay_ns)},
        "feature": {
            "vote_extensions_enable_height":
                str(p.feature.vote_extensions_enable_height),
            "pbts_enable_height": str(p.feature.pbts_enable_height)},
    }


def _params_from_json(obj: dict) -> ConsensusParams:
    def geti(d, k, default=0):
        v = d.get(k, default)
        return int(v) if v is not None else default

    p = ConsensusParams()
    if "block" in obj:
        p.block = BlockParams(max_bytes=geti(obj["block"], "max_bytes"),
                              max_gas=geti(obj["block"], "max_gas"))
    if "evidence" in obj:
        e = obj["evidence"]
        p.evidence = EvidenceParams(
            max_age_num_blocks=geti(e, "max_age_num_blocks"),
            max_age_duration_ns=geti(e, "max_age_duration"),
            max_bytes=geti(e, "max_bytes"))
    if "validator" in obj:
        p.validator = ValidatorParams(
            pub_key_types=list(obj["validator"].get("pub_key_types", [])))
    if "version" in obj:
        p.version = VersionParams(app=geti(obj["version"], "app"))
    if "synchrony" in obj:
        s = obj["synchrony"]
        p.synchrony = SynchronyParams(
            precision_ns=geti(s, "precision"),
            message_delay_ns=geti(s, "message_delay"))
    if "feature" in obj:
        f = obj["feature"]
        p.feature = FeatureParams(
            vote_extensions_enable_height=geti(
                f, "vote_extensions_enable_height"),
            pbts_enable_height=geti(f, "pbts_enable_height"))
    return p


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time: Timestamp = field(default_factory=Timestamp.zero)
    initial_height: int = 1
    consensus_params: ConsensusParams = field(
        default_factory=ConsensusParams)
    validators: list = field(default_factory=list)  # list[GenesisValidator]
    app_hash: bytes = b""
    app_state: object = None  # raw JSON value handed to the app at InitChain

    # -- validation (types/genesis.go ValidateAndComplete) -----------------

    def validate_and_complete(self) -> None:
        if not self.chain_id:
            raise ValueError("genesis doc must include non-empty chain_id")
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError(f"chain_id in genesis doc is too long "
                             f"(max: {MAX_CHAIN_ID_LEN})")
        if self.initial_height < 0:
            raise ValueError("initial_height cannot be negative")
        if self.initial_height == 0:
            self.initial_height = 1
        self.consensus_params.validate()
        for i, v in enumerate(self.validators):
            if v.power == 0:
                raise ValueError(
                    f"genesis file cannot contain validators with no voting "
                    f"power: {v.name or i}")
            if v.address and v.pub_key is not None \
                    and v.address != v.pub_key.address():
                raise ValueError(
                    f"incorrect address for validator {v.name or i}")
        if self.genesis_time.is_zero():
            self.genesis_time = Timestamp.now()

    def validator_hash(self, device="cuda") -> bytes:
        from .validator_set import ValidatorSet
        return ValidatorSet([v.to_validator()
                             for v in self.validators]).hash(device=device)

    # -- JSON --------------------------------------------------------------

    def to_json(self) -> str:
        obj = {
            "genesis_time": self.genesis_time.rfc3339(),
            "chain_id": self.chain_id,
            "initial_height": str(self.initial_height),
            "consensus_params": _params_to_json(self.consensus_params),
            "validators": [
                {"address": v.address.hex().upper(),
                 "pub_key": pubkey_to_json(v.pub_key),
                 "power": str(v.power),
                 "name": v.name}
                for v in self.validators],
            "app_hash": self.app_hash.hex().upper(),
        }
        if self.app_state is not None:
            obj["app_state"] = self.app_state
        return json.dumps(obj, indent=2)

    @staticmethod
    def from_json(data: str | bytes) -> "GenesisDoc":
        obj = json.loads(data)
        vals = []
        for v in obj.get("validators") or []:
            pk = pubkey_from_json(v["pub_key"])
            vals.append(GenesisValidator(
                pub_key=pk, power=int(v["power"]), name=v.get("name", ""),
                address=bytes.fromhex(v["address"]) if v.get("address")
                else b""))
        app_hash_s = obj.get("app_hash", "")
        doc = GenesisDoc(
            chain_id=obj["chain_id"],
            genesis_time=Timestamp.from_rfc3339(obj["genesis_time"])
            if obj.get("genesis_time") else Timestamp.zero(),
            initial_height=int(obj.get("initial_height", 1) or 1),
            consensus_params=_params_from_json(
                obj.get("consensus_params") or {}),
            validators=vals,
            app_hash=bytes.fromhex(app_hash_s) if app_hash_s else b"",
            app_state=obj.get("app_state"),
        )
        doc.validate_and_complete()
        return doc

    def hash(self) -> bytes:
        """Hash of the canonical JSON — used to verify genesis agreement
        across nodes (node/node.go genesisDocHashKey)."""
        return sum_sha256(self.to_json().encode())
