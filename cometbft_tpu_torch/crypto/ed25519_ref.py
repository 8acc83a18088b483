"""Pure-Python Ed25519 (RFC 8032 + ZIP-215 verify semantics).

The port's own copy of `cometbft_tpu.crypto.ed25519_ref`.  Host-side
reference implementation used for: signing (not a hot path — CometBFT's
privval signs one vote at a time), key generation, the static base-point
window table of the per-signature kernel, and the verdict oracle the
device path is held against.  Written from the RFC 8032 specification
math.
"""

from __future__ import annotations

import hashlib
import os

P = (1 << 255) - 19
L = (1 << 252) + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

# base point
_BY = (4 * pow(5, P - 2, P)) % P
_BX = None  # filled below


def _recover_x(y: int, sign: int) -> int | None:
    """x from y per RFC 8032 5.1.3; None if not on curve."""
    if y >= (1 << 255):
        return None
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    x = (u * pow(v, P - 2, P)) % P
    x = pow(x, (P + 3) // 8, P)
    if (x * x - u * pow(v, P - 2, P)) % P != 0:
        x = (x * SQRT_M1) % P
    if (v * x * x - u) % P != 0:
        return None
    if x == 0 and sign == 1:
        return None
    if x % 2 != sign:
        x = P - x
    return x


_BX = _recover_x(_BY, 0)
B = (_BX, _BY, 1, (_BX * _BY) % P)  # extended coords (X, Y, Z, T)
IDENT = (0, 1, 1, 0)


def point_add(p, q):
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = ((Y1 - X1) * (Y2 - X2)) % P
    Bv = ((Y1 + X1) * (Y2 + X2)) % P
    C = (2 * T1 * T2 * D) % P
    Dv = (2 * Z1 * Z2) % P
    E, F, G, H = (Bv - A) % P, (Dv - C) % P, (Dv + C) % P, (Bv + A) % P
    return ((E * F) % P, (G * H) % P, (F * G) % P, (E * H) % P)


def point_double(p):
    return point_add(p, p)


def point_neg(p):
    X, Y, Z, T = p
    return ((-X) % P, Y, Z, (-T) % P)


def point_mul(k: int, p):
    acc = IDENT
    while k:
        if k & 1:
            acc = point_add(acc, p)
        p = point_double(p)
        k >>= 1
    return acc


def point_eq(p, q) -> bool:
    X1, Y1, Z1, _ = p
    X2, Y2, Z2, _ = q
    return (X1 * Z2 - X2 * Z1) % P == 0 and (Y1 * Z2 - Y2 * Z1) % P == 0


def point_compress(p) -> bytes:
    X, Y, Z, _ = p
    zi = pow(Z, P - 2, P)
    x, y = (X * zi) % P, (Y * zi) % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def point_decompress(enc: bytes, zip215: bool = True):
    """Decode a point.  ZIP-215 mode skips the canonical-y check."""
    if len(enc) != 32:
        return None
    val = int.from_bytes(enc, "little")
    sign = val >> 255
    y = val & ((1 << 255) - 1)
    if not zip215 and y >= P:
        return None
    # ZIP-215 accepts non-canonical y; arithmetic reduces it implicitly
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    if v == 0:
        return None
    x = pow((u * pow(v, P - 2, P)) % P, (P + 3) // 8, P)
    if (v * x * x - u) % P != 0:
        x = (x * SQRT_M1) % P
    if (v * x * x - u) % P != 0:
        return None
    if x == 0 and sign == 1:
        return None
    if x % 2 != sign:
        x = P - x
    return (x, y % P, 1, (x * (y % P)) % P)


# ---------------------------------------------------------------------------
# keys / sign / verify
# ---------------------------------------------------------------------------

def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def pubkey_from_seed(seed: bytes) -> bytes:
    h = hashlib.sha512(seed).digest()
    return point_compress(point_mul(_clamp(h), B))


def keygen(seed: bytes | None = None) -> tuple[bytes, bytes]:
    """Returns (seed32, pubkey32)."""
    seed = seed if seed is not None else os.urandom(32)
    return seed, pubkey_from_seed(seed)


def sign(seed: bytes, msg: bytes) -> bytes:
    h = hashlib.sha512(seed).digest()
    a = _clamp(h)
    prefix = h[32:]
    A = point_compress(point_mul(a, B))
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    R = point_compress(point_mul(r, B))
    k = int.from_bytes(hashlib.sha512(R + A + msg).digest(), "little") % L
    s = (r + k * a) % L
    return R + s.to_bytes(32, "little")


def verify(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """ZIP-215 cofactored verification: [8][s]B == [8]R + [8][k]A."""
    if len(sig) != 64 or len(pubkey) != 32:
        return False
    A = point_decompress(pubkey)
    R = point_decompress(sig[:32])
    if A is None or R is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    k = int.from_bytes(hashlib.sha512(sig[:32] + pubkey + msg).digest(),
                       "little") % L
    lhs = point_mul(8 * s, B)
    rhs = point_add(point_mul(8, R), point_mul(8 * k, A))
    return point_eq(lhs, rhs)


def base_window_table(width_bits: int = 4) -> list[tuple[int, int, int, int]]:
    """[k]B for k in 0..2**w-1, extended affine-Z coords, for device tables."""
    out = [IDENT]
    for k in range(1, 1 << width_bits):
        out.append(point_add(out[-1], B))
    return out
