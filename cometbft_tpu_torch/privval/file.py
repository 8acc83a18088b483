"""File-backed private validator with double-sign protection (the
port's copy of `cometbft_tpu.privval.file`; CometBFT privval/file.go).
Signing is the host's pure-Python ed25519 (crypto/ed25519.PrivKey).

The LastSignState is persisted BEFORE a signature is released, so a
crash between signing and gossip can never produce two different
signatures for one (height, round, step): on restart, a re-sign of the
same HRS either replays the saved signature (same sign-bytes, or
differing only in timestamp) or errors out.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass

from ..crypto import ed25519
from ..types import canonical
from ..types.timestamp import Timestamp
from ..types.vote import PRECOMMIT_TYPE, PREVOTE_TYPE, Proposal, Vote

STEP_NONE = 0
STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3


def vote_to_step(vote: Vote) -> int:
    if vote.type == PREVOTE_TYPE:
        return STEP_PREVOTE
    if vote.type == PRECOMMIT_TYPE:
        return STEP_PRECOMMIT
    raise ValueError(f"unknown vote type {vote.type}")


def _write_file_atomic(path: str, data: bytes, mode: int = 0o600) -> None:
    """internal/tempfile analog: write-rename so readers never see a
    torn file."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-privval-")
    try:
        try:
            os.write(fd, data)
            os.fsync(fd)
        finally:
            os.close(fd)
        os.chmod(tmp, mode)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class DoubleSignError(Exception):
    pass


@dataclass
class LastSignState:
    """privval/file.go FilePVLastSignState."""

    height: int = 0
    round: int = 0
    step: int = STEP_NONE
    signature: bytes = b""
    sign_bytes: bytes = b""
    file_path: str = ""

    def check_hrs(self, height: int, round_: int, step: int) -> bool:
        """True when (h,r,s) matches the last signed state and the
        previous signature should be replayed (file.go:100)."""
        if self.height > height:
            raise DoubleSignError(
                f"height regression: got {height}, last {self.height}")
        if self.height != height:
            return False
        if self.round > round_:
            raise DoubleSignError(
                f"round regression at height {height}: got {round_}, "
                f"last {self.round}")
        if self.round != round_:
            return False
        if self.step > step:
            raise DoubleSignError(
                f"step regression at {height}/{round_}: got {step}, "
                f"last {self.step}")
        if self.step == step:
            if not self.sign_bytes:
                raise DoubleSignError("no SignBytes found")
            if not self.signature:
                raise RuntimeError("signature absent with SignBytes present")
            return True
        return False

    def save(self) -> None:
        if not self.file_path:
            return
        payload = json.dumps({
            "height": str(self.height),
            "round": self.round,
            "step": self.step,
            "signature": self.signature.hex().upper(),
            "signbytes": self.sign_bytes.hex().upper(),
        }, indent=2).encode()
        _write_file_atomic(self.file_path, payload)

    @staticmethod
    def load(path: str) -> "LastSignState":
        with open(path, "rb") as f:
            obj = json.loads(f.read())
        return LastSignState(
            height=int(obj.get("height", "0")),
            round=int(obj.get("round", 0)),
            step=int(obj.get("step", 0)),
            signature=bytes.fromhex(obj.get("signature", "")),
            sign_bytes=bytes.fromhex(obj.get("signbytes", "")),
            file_path=path)

    def reset(self) -> None:
        self.height = 0
        self.round = 0
        self.step = STEP_NONE
        self.signature = b""
        self.sign_bytes = b""


def _only_differ_by_timestamp(last: bytes, new: bytes, ts_field: int
                              ) -> tuple[Timestamp | None, bool]:
    """file.go:442: equal after stripping the canonical timestamp."""
    if not last:
        return None, False
    last_z, last_ts = canonical.split_timestamp(last, ts_field)
    new_z, _ = canonical.split_timestamp(new, ts_field)
    if last_z == new_z:
        return last_ts, True
    return None, False


@dataclass
class FilePVKey:
    address: bytes = b""
    pub_key: object = None
    priv_key: object = None
    file_path: str = ""

    def save(self) -> None:
        if not self.file_path:
            return
        from ..libs import tmjson
        payload = json.dumps({
            "address": self.address.hex().upper(),
            "pub_key": tmjson.to_obj(self.pub_key),
            "priv_key": tmjson.to_obj(self.priv_key),
        }, indent=2).encode()
        _write_file_atomic(self.file_path, payload)

    @staticmethod
    def load(path: str) -> "FilePVKey":
        with open(path, "rb") as f:
            obj = json.loads(f.read())
        from ..libs import tmjson
        priv = tmjson.from_obj(obj["priv_key"])
        if isinstance(priv, dict):      # untyped legacy file: ed25519
            import base64
            priv = ed25519.PrivKey(
                base64.b64decode(obj["priv_key"]["value"]))
        pub = priv.pub_key()
        return FilePVKey(address=pub.address(), pub_key=pub, priv_key=priv,
                         file_path=path)


def _b64(b: bytes) -> str:
    import base64
    return base64.b64encode(b).decode()


class FilePV:
    """types.PrivValidator backed by two JSON files: key (immutable) and
    last-sign-state (mutable, saved before every signature release)."""

    def __init__(self, priv_key, key_file_path: str = "",
                 state_file_path: str = ""):
        pub = priv_key.pub_key()
        self.key = FilePVKey(address=pub.address(), pub_key=pub,
                             priv_key=priv_key, file_path=key_file_path)
        self.last_sign_state = LastSignState(file_path=state_file_path)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def generate(key_file_path: str = "", state_file_path: str = "",
                 seed: bytes | None = None,
                 key_type: str = "ed25519") -> "FilePV":
        """privval/file.go GenFilePV; key_type mirrors the reference's
        `cometbft init --key-type` (ed25519 | secp256k1 | sr25519 —
        validator params additionally restrict which may validate)."""
        if key_type == "ed25519":
            priv = ed25519.PrivKey.generate(seed)
        elif key_type == "secp256k1":
            from ..crypto import secp256k1
            priv = secp256k1.PrivKey.generate(seed)
        elif key_type == "sr25519":
            from ..crypto import sr25519
            priv = sr25519.PrivKey.generate(seed)
        else:
            raise ValueError(f"unsupported key type {key_type!r}")
        return FilePV(priv, key_file_path, state_file_path)

    @staticmethod
    def load(key_file_path: str, state_file_path: str) -> "FilePV":
        key = FilePVKey.load(key_file_path)
        pv = FilePV(key.priv_key, key_file_path, state_file_path)
        if os.path.exists(state_file_path) and \
                os.path.getsize(state_file_path) > 0:
            pv.last_sign_state = LastSignState.load(state_file_path)
        return pv

    @staticmethod
    def load_or_generate(key_file_path: str, state_file_path: str,
                         key_type: str = "ed25519") -> "FilePV":
        if os.path.exists(key_file_path):
            return FilePV.load(key_file_path, state_file_path)
        pv = FilePV.generate(key_file_path, state_file_path,
                             key_type=key_type)
        pv.save()
        return pv

    # -- PrivValidator interface ------------------------------------------
    def get_address(self) -> bytes:
        return self.key.address

    def get_pub_key(self):
        return self.key.pub_key

    def sign_vote(self, chain_id: str, vote: Vote,
                  sign_extension: bool = False) -> None:
        """Sets vote.signature (and extension_signature); enforces the
        HRS double-sign rules (file.go:319)."""
        height, round_, step = vote.height, vote.round, vote_to_step(vote)
        lss = self.last_sign_state
        same_hrs = lss.check_hrs(height, round_, step)

        sign_bytes = vote.sign_bytes(chain_id)

        if sign_extension:
            # extensions are app-nondeterministic: always re-sign them
            # (file.go:331-349)
            if vote.type == PRECOMMIT_TYPE and not vote.block_id.is_nil():
                vote.extension_signature = self.key.priv_key.sign(
                    vote.extension_sign_bytes(chain_id))
            elif vote.extension:
                raise ValueError(
                    "unexpected vote extension on non-commit vote")
            else:
                vote.extension_signature = b""

        if same_hrs:
            if sign_bytes == lss.sign_bytes:
                vote.signature = lss.signature
                return
            ts, ok = _only_differ_by_timestamp(
                lss.sign_bytes, sign_bytes, canonical.VOTE_TIMESTAMP_FIELD)
            if ok:
                vote.timestamp = ts
                vote.signature = lss.signature
                return
            raise DoubleSignError("conflicting data")

        sig = self.key.priv_key.sign(sign_bytes)
        self._save_signed(height, round_, step, sign_bytes, sig)
        vote.signature = sig

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        height, round_ = proposal.height, proposal.round
        lss = self.last_sign_state
        same_hrs = lss.check_hrs(height, round_, STEP_PROPOSE)

        sign_bytes = proposal.sign_bytes(chain_id)
        if same_hrs:
            if sign_bytes == lss.sign_bytes:
                proposal.signature = lss.signature
                return
            ts, ok = _only_differ_by_timestamp(
                lss.sign_bytes, sign_bytes,
                canonical.PROPOSAL_TIMESTAMP_FIELD)
            if ok:
                proposal.timestamp = ts
                proposal.signature = lss.signature
                return
            raise DoubleSignError("conflicting data")

        sig = self.key.priv_key.sign(sign_bytes)
        self._save_signed(height, round_, STEP_PROPOSE, sign_bytes, sig)
        proposal.signature = sig

    def sign_bytes_raw(self, data: bytes) -> bytes:
        """file.go:285 SignBytes — arbitrary payloads (p2p auth etc)."""
        return self.key.priv_key.sign(data)

    # -- persistence -------------------------------------------------------
    def save(self) -> None:
        self.key.save()
        self.last_sign_state.save()

    def reset(self) -> None:
        self.last_sign_state.reset()
        self.save()

    def _save_signed(self, height: int, round_: int, step: int,
                     sign_bytes: bytes, sig: bytes) -> None:
        lss = self.last_sign_state
        lss.height = height
        lss.round = round_
        lss.step = step
        lss.signature = sig
        lss.sign_bytes = sign_bytes
        lss.save()
