"""Pure-Python X25519 and ChaCha20-Poly1305 (RFC 7748 / RFC 8439): the
port's copy of `cometbft_tpu.crypto.aead`.

The p2p SecretConnection handshake (p2p/conn/secret_connection.py) runs
on these two primitives.  The port depends on no `cryptography` wheel,
so this module is its only implementation: the same algorithms, bit for
bit wire compatible with a wheel-backed peer, on Python integers.  A
handshake's two X25519 ladders cost milliseconds, and each sealed
1,024-byte frame a ChaCha20 pass and a Poly1305 tag in Python.

``x25519(scalar, u)`` / ``x25519_base(scalar)`` and a
``ChaCha20Poly1305`` class with ``encrypt(nonce, data, aad)`` /
``decrypt(nonce, data, aad)`` (decrypt raises ValueError on a bad tag).
"""

from __future__ import annotations

import hmac
import struct

# -- X25519 (RFC 7748) -------------------------------------------------------

_P = 2 ** 255 - 19
_A24 = 121665
_BASE_U = (9).to_bytes(32, "little")


def _decode_scalar(k: bytes) -> int:
    if len(k) != 32:
        raise ValueError("X25519 scalar must be 32 bytes")
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(b, "little")


def _decode_u(u: bytes) -> int:
    if len(u) != 32:
        raise ValueError("X25519 u-coordinate must be 32 bytes")
    b = bytearray(u)
    b[31] &= 127                    # RFC 7748: mask the top bit
    return int.from_bytes(b, "little") % _P


def x25519(scalar: bytes, u: bytes) -> bytes:
    """Montgomery-ladder scalar multiplication on Curve25519."""
    k = _decode_scalar(scalar)
    x1 = _decode_u(u)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in range(254, -1, -1):
        kt = (k >> t) & 1
        swap ^= kt
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = kt
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = da + cb
        x3 = x3 * x3 % _P
        z3 = da - cb
        z3 = x1 * (z3 * z3 % _P) % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, z2 = x3, z3
    out = x2 * pow(z2, _P - 2, _P) % _P
    return out.to_bytes(32, "little")


def x25519_base(scalar: bytes) -> bytes:
    """Public key for a private scalar (u = 9)."""
    return x25519(scalar, _BASE_U)


# -- ChaCha20 (RFC 8439 section 2.3) -----------------------------------------

_SIGMA = struct.unpack("<4I", b"expand 32-byte k")
_MASK = 0xFFFFFFFF


def _chacha20_block(key_words, counter: int, nonce_words) -> bytes:
    x0, x1, x2, x3 = _SIGMA
    x4, x5, x6, x7, x8, x9, x10, x11 = key_words
    x12 = counter & _MASK
    x13, x14, x15 = nonce_words
    s = (x0, x1, x2, x3, x4, x5, x6, x7,
         x8, x9, x10, x11, x12, x13, x14, x15)
    for _ in range(10):             # 10 double rounds = 20 rounds
        # column round
        x0 = (x0 + x4) & _MASK; x12 ^= x0; x12 = ((x12 << 16) | (x12 >> 16)) & _MASK  # noqa: E702
        x8 = (x8 + x12) & _MASK; x4 ^= x8; x4 = ((x4 << 12) | (x4 >> 20)) & _MASK  # noqa: E702
        x0 = (x0 + x4) & _MASK; x12 ^= x0; x12 = ((x12 << 8) | (x12 >> 24)) & _MASK  # noqa: E702
        x8 = (x8 + x12) & _MASK; x4 ^= x8; x4 = ((x4 << 7) | (x4 >> 25)) & _MASK  # noqa: E702
        x1 = (x1 + x5) & _MASK; x13 ^= x1; x13 = ((x13 << 16) | (x13 >> 16)) & _MASK  # noqa: E702
        x9 = (x9 + x13) & _MASK; x5 ^= x9; x5 = ((x5 << 12) | (x5 >> 20)) & _MASK  # noqa: E702
        x1 = (x1 + x5) & _MASK; x13 ^= x1; x13 = ((x13 << 8) | (x13 >> 24)) & _MASK  # noqa: E702
        x9 = (x9 + x13) & _MASK; x5 ^= x9; x5 = ((x5 << 7) | (x5 >> 25)) & _MASK  # noqa: E702
        x2 = (x2 + x6) & _MASK; x14 ^= x2; x14 = ((x14 << 16) | (x14 >> 16)) & _MASK  # noqa: E702
        x10 = (x10 + x14) & _MASK; x6 ^= x10; x6 = ((x6 << 12) | (x6 >> 20)) & _MASK  # noqa: E702
        x2 = (x2 + x6) & _MASK; x14 ^= x2; x14 = ((x14 << 8) | (x14 >> 24)) & _MASK  # noqa: E702
        x10 = (x10 + x14) & _MASK; x6 ^= x10; x6 = ((x6 << 7) | (x6 >> 25)) & _MASK  # noqa: E702
        x3 = (x3 + x7) & _MASK; x15 ^= x3; x15 = ((x15 << 16) | (x15 >> 16)) & _MASK  # noqa: E702
        x11 = (x11 + x15) & _MASK; x7 ^= x11; x7 = ((x7 << 12) | (x7 >> 20)) & _MASK  # noqa: E702
        x3 = (x3 + x7) & _MASK; x15 ^= x3; x15 = ((x15 << 8) | (x15 >> 24)) & _MASK  # noqa: E702
        x11 = (x11 + x15) & _MASK; x7 ^= x11; x7 = ((x7 << 7) | (x7 >> 25)) & _MASK  # noqa: E702
        # diagonal round
        x0 = (x0 + x5) & _MASK; x15 ^= x0; x15 = ((x15 << 16) | (x15 >> 16)) & _MASK  # noqa: E702
        x10 = (x10 + x15) & _MASK; x5 ^= x10; x5 = ((x5 << 12) | (x5 >> 20)) & _MASK  # noqa: E702
        x0 = (x0 + x5) & _MASK; x15 ^= x0; x15 = ((x15 << 8) | (x15 >> 24)) & _MASK  # noqa: E702
        x10 = (x10 + x15) & _MASK; x5 ^= x10; x5 = ((x5 << 7) | (x5 >> 25)) & _MASK  # noqa: E702
        x1 = (x1 + x6) & _MASK; x12 ^= x1; x12 = ((x12 << 16) | (x12 >> 16)) & _MASK  # noqa: E702
        x11 = (x11 + x12) & _MASK; x6 ^= x11; x6 = ((x6 << 12) | (x6 >> 20)) & _MASK  # noqa: E702
        x1 = (x1 + x6) & _MASK; x12 ^= x1; x12 = ((x12 << 8) | (x12 >> 24)) & _MASK  # noqa: E702
        x11 = (x11 + x12) & _MASK; x6 ^= x11; x6 = ((x6 << 7) | (x6 >> 25)) & _MASK  # noqa: E702
        x2 = (x2 + x7) & _MASK; x13 ^= x2; x13 = ((x13 << 16) | (x13 >> 16)) & _MASK  # noqa: E702
        x8 = (x8 + x13) & _MASK; x7 ^= x8; x7 = ((x7 << 12) | (x7 >> 20)) & _MASK  # noqa: E702
        x2 = (x2 + x7) & _MASK; x13 ^= x2; x13 = ((x13 << 8) | (x13 >> 24)) & _MASK  # noqa: E702
        x8 = (x8 + x13) & _MASK; x7 ^= x8; x7 = ((x7 << 7) | (x7 >> 25)) & _MASK  # noqa: E702
        x3 = (x3 + x4) & _MASK; x14 ^= x3; x14 = ((x14 << 16) | (x14 >> 16)) & _MASK  # noqa: E702
        x9 = (x9 + x14) & _MASK; x4 ^= x9; x4 = ((x4 << 12) | (x4 >> 20)) & _MASK  # noqa: E702
        x3 = (x3 + x4) & _MASK; x14 ^= x3; x14 = ((x14 << 8) | (x14 >> 24)) & _MASK  # noqa: E702
        x9 = (x9 + x14) & _MASK; x4 ^= x9; x4 = ((x4 << 7) | (x4 >> 25)) & _MASK  # noqa: E702
    out = (x0, x1, x2, x3, x4, x5, x6, x7,
           x8, x9, x10, x11, x12, x13, x14, x15)
    return struct.pack("<16I", *((a + b) & _MASK
                                 for a, b in zip(out, s)))


def chacha20_xor(key: bytes, counter: int, nonce: bytes,
                 data: bytes) -> bytes:
    """XOR `data` with the ChaCha20 keystream (encrypt == decrypt)."""
    key_words = struct.unpack("<8I", key)
    nonce_words = struct.unpack("<3I", nonce)
    out = bytearray(len(data))
    for i in range(0, len(data), 64):
        block = _chacha20_block(key_words, counter + (i >> 6),
                                nonce_words)
        chunk = data[i:i + 64]
        out[i:i + len(chunk)] = bytes(
            a ^ b for a, b in zip(chunk, block))
    return bytes(out)


# -- Poly1305 (RFC 8439 section 2.5) -----------------------------------------

_POLY_P = (1 << 130) - 5
_R_CLAMP = 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF


def poly1305_mac(key: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(key[:16], "little") & _R_CLAMP
    s = int.from_bytes(key[16:32], "little")
    acc = 0
    for i in range(0, len(msg), 16):
        block = msg[i:i + 16]
        n = int.from_bytes(block, "little") | (1 << (8 * len(block)))
        acc = (acc + n) * r % _POLY_P
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


# -- AEAD_CHACHA20_POLY1305 (RFC 8439 section 2.8) ---------------------------

def _pad16(data: bytes) -> bytes:
    rem = len(data) % 16
    return b"\x00" * (16 - rem) if rem else b""


class ChaCha20Poly1305:
    """Drop-in for cryptography's ChaCha20Poly1305 as SecretConnection
    uses it: 12-byte nonces, ciphertext||16-byte tag, ValueError on
    authentication failure."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)

    def _tag(self, nonce: bytes, ct: bytes, aad: bytes) -> bytes:
        otk = _chacha20_block(
            struct.unpack("<8I", self._key), 0,
            struct.unpack("<3I", nonce))[:32]
        mac_data = (aad + _pad16(aad) + ct + _pad16(ct)
                    + struct.pack("<QQ", len(aad), len(ct)))
        return poly1305_mac(otk, mac_data)

    def encrypt(self, nonce: bytes, data: bytes,
                aad: bytes | None) -> bytes:
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        aad = aad or b""
        ct = chacha20_xor(self._key, 1, nonce, data)
        return ct + self._tag(nonce, ct, aad)

    def decrypt(self, nonce: bytes, data: bytes,
                aad: bytes | None) -> bytes:
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        if len(data) < 16:
            raise ValueError("ciphertext too short")
        aad = aad or b""
        ct, tag = data[:-16], data[-16:]
        if not hmac.compare_digest(self._tag(nonce, ct, aad), tag):
            raise ValueError("authentication tag mismatch")
        return chacha20_xor(self._key, 1, nonce, ct)
