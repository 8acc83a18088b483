"""BLS12-381 min-pk keys over the repository's C++ library (the port's
copy of `cometbft_tpu.crypto.bls12381`).

The library's sources are `native/bls12381/` (pairing, hash-to-G2,
compressed encodings).  The port compiles `bls.cc` with
`g++ -O2 -shared -fPIC` into its own ignored build directory
(`ops/build/`, under a name keyed by a hash of the sources and flags) at
first use, and loads only that library.  CometBFT gates this scheme
behind a build tag (crypto/bls12381/key.go); here the gate is the
library: `enabled()` is False while it cannot be built or fails its
self-test, and signing or verifying raises then.  Nothing of it runs on
the card.

Wire shapes are CometBFT's: 48-byte compressed G1 public keys, 96-byte
compressed G2 signatures, 32-byte scalars, key type "bls12_381",
address = the first 20 bytes of SHA-256(pubkey).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from dataclasses import dataclass
from pathlib import Path

from ..libs import lockrank
from .hash import sum_sha256

KEY_TYPE = "bls12_381"
PUBKEY_SIZE = 48
PRIVKEY_SIZE = 32
SIGNATURE_SIZE = 96

# CometBFT key_bls12381.go MaxMsgLen: messages longer than 32 bytes are
# SHA-256 pre-hashed before signing and verifying.  Shorter messages are
# signable but never verifiable there (a [32]byte conversion panics), so
# verify_signature answers False for them.
MAX_MSG_LEN = 32

SOURCE_DIR = Path(__file__).resolve().parents[2] / "native" / "bls12381"
BUILD_DIR = Path(__file__).resolve().parents[1] / "ops" / "build"
CXX_FLAGS = ["-O2", "-shared", "-fPIC"]

_SIGNATURES = {
    "bls_keygen": [ctypes.c_char_p, ctypes.c_char_p],
    "bls_sk_to_pk": [ctypes.c_char_p, ctypes.c_char_p],
    "bls_sign": [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
                 ctypes.c_char_p],
    "bls_verify": [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
                   ctypes.c_char_p],
    "bls_pk_validate": [ctypes.c_char_p],
    "bls_aggregate_sigs": [ctypes.c_char_p, ctypes.c_size_t,
                           ctypes.c_char_p],
    "bls_aggregate_pks": [ctypes.c_char_p, ctypes.c_size_t,
                          ctypes.c_char_p],
    "bls_selftest": [],
    "bls_sha256": [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p],
    "bls_expand_message_xmd": [ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.c_char_p, ctypes.c_size_t],
    "bls_hash_to_g2_compressed": [ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.c_char_p],
}

_lib = None
_failed: str | None = None
_lib_lock = lockrank.RankedLock("bls12381.lib")


def _prehash(msg: bytes) -> bytes:
    return sum_sha256(msg) if len(msg) > MAX_MSG_LEN else msg


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for f in sorted(SOURCE_DIR.iterdir()):
        if f.suffix in (".cc", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"libbls12381-{h.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                    str(SOURCE_DIR / "bls.cc")],
                   check=True, capture_output=True)
    os.replace(tmp, target)


def _load():
    """The loaded library, compiled on first use; None (and the reason
    kept) where g++ is missing or the build fails."""
    global _lib, _failed
    with _lib_lock:
        if _lib is not None or _failed is not None:
            return _lib
        try:
            target = library_path()
            if not target.exists():
                _compile(target)
            lib = ctypes.CDLL(str(target))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
        except (OSError, subprocess.CalledProcessError) as e:
            _failed = f"bls12381 library did not build or load: {e!r}"
            return None
        if lib.bls_selftest() != 0:
            _failed = "bls12381 native self-test failed"
            return None
        _lib = lib
        return _lib


def enabled() -> bool:
    """CometBFT's Enabled: True iff the library builds (on first use),
    loads and passes its self-test."""
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"bls12381 is not enabled: {_failed}")
    return lib


@dataclass(frozen=True)
class PubKey:
    data: bytes

    def __post_init__(self):
        if len(self.data) != PUBKEY_SIZE:
            raise ValueError("bls12_381 pubkey must be 48 bytes")

    def type(self) -> str:
        return KEY_TYPE

    def bytes(self) -> bytes:
        return self.data

    def address(self) -> bytes:
        return sum_sha256(self.data)[:20]

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_SIZE:
            return False
        if len(msg) < MAX_MSG_LEN:
            return False
        lib = _require()
        msg = _prehash(msg)
        return bool(lib.bls_verify(self.data, msg, len(msg), sig))

    def validate(self) -> bool:
        return bool(_require().bls_pk_validate(self.data))

    def __bytes__(self):
        return self.data


@dataclass(frozen=True)
class PrivKey:
    data: bytes

    def __post_init__(self):
        if len(self.data) != PRIVKEY_SIZE:
            raise ValueError("bls12_381 privkey must be 32 bytes")

    @staticmethod
    def generate(seed: bytes | None = None) -> "PrivKey":
        import secrets

        lib = _require()
        seed = seed if seed is not None else secrets.token_bytes(32)
        if len(seed) != 32:
            raise ValueError("seed must be 32 bytes")
        out = ctypes.create_string_buffer(PRIVKEY_SIZE)
        if not lib.bls_keygen(seed, out):
            raise RuntimeError("bls keygen failed")
        return PrivKey(out.raw)

    def type(self) -> str:
        return KEY_TYPE

    def bytes(self) -> bytes:
        return self.data

    def pub_key(self) -> PubKey:
        lib = _require()
        out = ctypes.create_string_buffer(PUBKEY_SIZE)
        if not lib.bls_sk_to_pk(self.data, out):
            raise RuntimeError("invalid bls secret key")
        return PubKey(out.raw)

    def sign(self, msg: bytes) -> bytes:
        lib = _require()
        msg = _prehash(msg)
        out = ctypes.create_string_buffer(SIGNATURE_SIZE)
        if not lib.bls_sign(self.data, msg, len(msg), out):
            raise RuntimeError("bls sign failed")
        return out.raw


def aggregate_signatures(sigs: list[bytes]) -> bytes:
    lib = _require()
    buf = b"".join(sigs)
    if len(buf) != SIGNATURE_SIZE * len(sigs):
        raise ValueError("bad signature lengths")
    out = ctypes.create_string_buffer(SIGNATURE_SIZE)
    if not lib.bls_aggregate_sigs(buf, len(sigs), out):
        raise ValueError("invalid signature in aggregate")
    return out.raw


def aggregate_pubkeys(pks: list[bytes]) -> bytes:
    lib = _require()
    buf = b"".join(pks)
    if len(buf) != PUBKEY_SIZE * len(pks):
        raise ValueError("bad pubkey lengths")
    out = ctypes.create_string_buffer(PUBKEY_SIZE)
    if not lib.bls_aggregate_pks(buf, len(pks), out):
        raise ValueError("invalid pubkey in aggregate")
    return out.raw


def expand_message_xmd(msg: bytes, dst: bytes, length: int) -> bytes:
    lib = _require()
    out = ctypes.create_string_buffer(length)
    lib.bls_expand_message_xmd(msg, len(msg), dst, len(dst), out, length)
    return out.raw


def hash_to_g2(msg: bytes, dst: bytes) -> bytes:
    """RFC 9380 hash-to-G2 (BLS12381G2_XMD:SHA-256_SSWU_RO_ with `dst`),
    compressed."""
    lib = _require()
    out = ctypes.create_string_buffer(SIGNATURE_SIZE)
    if not lib.bls_hash_to_g2_compressed(msg, len(msg), dst, len(dst), out):
        raise RuntimeError("hash_to_g2 failed")
    return out.raw
