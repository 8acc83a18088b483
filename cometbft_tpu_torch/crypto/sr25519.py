"""sr25519: Schnorr signatures over ristretto255 with Merlin transcripts
(schnorrkel), CometBFT's third consensus key type — the port's own copy
of `cometbft_tpu.crypto.sr25519`, keys and signatures byte for byte.

Wire format and transcript layout follow the schnorrkel spec:
  context   : SigningContext(b"") — CometBFT's empty signing context
  transcript: proto-name "Schnorr-sig", commit pk, commit R,
              challenge "sign:c" (64 bytes, reduced mod L)
  signature : R_ristretto(32) || s_LE(32) with bit 7 of byte 63 set
              (the schnorrkel "signature marker")

Batches run on the ed25519 device kernels (crypto/batch
.CudaSr25519BatchVerifier): the verify equation s*B = R + k*A is over
edwards25519 points, so the host decodes A and R from ristretto,
re-encodes them in Edwards compressed form (to_edwards_inputs) and puts
the Merlin challenge k where SHA-512's h goes.  The addresses are the
first 20 bytes of SHA-256 of the key.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

from . import ed25519_ref as ed
from . import ristretto as rst
from .hash import sum_sha256
from .strobe import Transcript

KEY_TYPE = "sr25519"
PUBKEY_SIZE = 32
PRIVKEY_SIZE = 64        # scalar(32) || nonce(32)
SIGNATURE_SIZE = 64
L = ed.L


def _signing_transcript(msg: bytes) -> Transcript:
    """signing_context(b"").bytes(msg), CometBFT's context."""
    t = Transcript(b"SigningContext")
    t.append_message(b"", b"")
    t.append_message(b"sign-bytes", msg)
    return t


def _reduce_wide(b: bytes) -> int:
    return int.from_bytes(b, "little") % L


def challenge_scalar(msg: bytes, pub_enc: bytes, r_enc: bytes) -> int:
    """The verification challenge k for (pub, R, msg) — shared by the
    single and batch paths."""
    t = _signing_transcript(msg)
    t.append_message(b"proto-name", b"Schnorr-sig")
    t.append_message(b"sign:pk", pub_enc)
    t.append_message(b"sign:R", r_enc)
    return _reduce_wide(t.challenge_bytes(b"sign:c", 64))


@dataclass(frozen=True)
class PubKey:
    data: bytes

    def __post_init__(self):
        if len(self.data) != PUBKEY_SIZE:
            raise ValueError("sr25519 pubkey must be 32 bytes")

    def type(self) -> str:
        return KEY_TYPE

    def bytes(self) -> bytes:
        return self.data

    def address(self) -> bytes:
        """First 20 bytes of SHA-256 (CometBFT's address rule for
        sr25519 keys)."""
        return sum_sha256(self.data)[:20]

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_SIZE:
            return False
        if sig[63] & 0x80 == 0:      # schnorrkel signature marker
            return False
        r_enc = sig[:32]
        s_bytes = bytes(sig[32:63]) + bytes([sig[63] & 0x7F])
        s = int.from_bytes(s_bytes, "little")
        if s >= L:
            return False
        a_pt = rst.decode(self.data)
        r_pt = rst.decode(r_enc)
        if a_pt is None or r_pt is None:
            return False
        k = challenge_scalar(msg, self.data, r_enc)
        # s*B == R + k*A
        lhs = ed.point_mul(s, ed.B)
        rhs = ed.point_add(r_pt, ed.point_mul(k, a_pt))
        return rst.eq(lhs, rhs)

    def __bytes__(self):
        return self.data


@dataclass(frozen=True)
class PrivKey:
    data: bytes              # scalar(32, LE) || nonce(32)

    def __post_init__(self):
        if len(self.data) != PRIVKEY_SIZE:
            raise ValueError("sr25519 privkey must be 64 bytes")

    @staticmethod
    def generate(seed: bytes | None = None) -> "PrivKey":
        if seed is None:
            seed = os.urandom(32)
        if len(seed) != 32:
            raise ValueError("seed must be 32 bytes")
        # derive scalar + nonce from the seed (our own KDF; schnorrkel
        # accepts any scalar — wire compat is about signatures, not
        # key derivation); the JAX package's derivation, byte for byte
        h = hashlib.sha512(b"cometbft-tpu/sr25519" + seed).digest()
        scalar = _reduce_wide(h)
        return PrivKey(scalar.to_bytes(32, "little") + h[32:])

    def type(self) -> str:
        return KEY_TYPE

    def bytes(self) -> bytes:
        return self.data

    @property
    def _scalar(self) -> int:
        return int.from_bytes(self.data[:32], "little") % L

    def pub_key(self) -> PubKey:
        return PubKey(rst.encode(ed.point_mul(self._scalar, ed.B)))

    def sign(self, msg: bytes) -> bytes:
        pub_enc = self.pub_key().data
        t = _signing_transcript(msg)
        t.append_message(b"proto-name", b"Schnorr-sig")
        t.append_message(b"sign:pk", pub_enc)
        # deterministic witness from the nonce half + transcript state
        # (schnorrkel mixes the nonce into the transcript rng the same
        # way; any r yields a valid signature)
        wt = t.clone()
        wt.append_message(b"proto-witness", self.data[32:])
        r = _reduce_wide(wt.challenge_bytes(b"witness", 64))
        r_enc = rst.encode(ed.point_mul(r, ed.B))
        t.append_message(b"sign:R", r_enc)
        k = _reduce_wide(t.challenge_bytes(b"sign:c", 64))
        s = (k * self._scalar + r) % L
        s_bytes = bytearray(s.to_bytes(32, "little"))
        s_bytes[31] |= 0x80
        return r_enc + bytes(s_bytes)


def to_edwards_inputs(pub: bytes, msg: bytes, sig: bytes
                      ) -> tuple[bytes, bytes, int, int] | None:
    """Translate an sr25519 (pub, msg, sig) into the ed25519 device
    kernel's input domain: Edwards-compressed A and R, scalar s, and
    the Merlin challenge k standing in for SHA512(R||A||M) mod L.
    Returns None on structural rejection."""
    if len(sig) != SIGNATURE_SIZE or len(pub) != PUBKEY_SIZE:
        return None
    if sig[63] & 0x80 == 0:
        return None
    s = int.from_bytes(bytes(sig[32:63]) + bytes([sig[63] & 0x7F]),
                       "little")
    if s >= L:
        return None
    a_pt = rst.decode(pub)
    r_pt = rst.decode(sig[:32])
    if a_pt is None or r_pt is None:
        return None
    k = challenge_scalar(msg, pub, sig[:32])
    return (ed.point_compress(a_pt), ed.point_compress(r_pt), s, k)
