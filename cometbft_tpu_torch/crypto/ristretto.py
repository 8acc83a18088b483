"""ristretto255 (RFC 9496) over the edwards25519 field: the group under
sr25519 (schnorrkel) — the port's own copy of
`cometbft_tpu.crypto.ristretto`.

Points are extended-Edwards (x, y, z, t) integer tuples, shared with the
port's ed25519_ref; encodings are the canonical 32-byte ristretto
strings.  A decoded point lies in 2E (the image of doubling), where the
only torsion is E[4]; ristretto equality compares cosets mod E[4], and
the device's cofactored check compares points mod E[8], which on 2E is
the same relation.  That is what lets sr25519 batches run on the
ed25519 kernels.
"""

from __future__ import annotations

from . import ed25519_ref as ed

P = ed.P
D = ed.D
SQRT_M1 = ed.SQRT_M1

def _is_negative(x: int) -> bool:
    return (x % P) & 1 == 1


def _abs(x: int) -> int:
    x %= P
    return P - x if _is_negative(x) else x


def _sqrt_ratio_m1(u: int, v: int) -> tuple[bool, int]:
    """(was_square, sqrt(u/v) or sqrt(i*u/v)), RFC 9496 §4.2."""
    u, v = u % P, v % P
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    correct = check == u % P
    flipped = check == (-u) % P
    flipped_i = check == (-u) % P * SQRT_M1 % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    was_square = correct or flipped
    return was_square, _abs(r)


# constant 1/sqrt(a-d) with a = -1 (RFC 9496 §4.1)
_ok, INVSQRT_A_MINUS_D = _sqrt_ratio_m1(1, (-1 - D) % P)
assert _ok


def decode(enc: bytes):
    """32-byte ristretto string -> extended point, or None if invalid."""
    if len(enc) != 32:
        return None
    s = int.from_bytes(enc, "little")
    if s >= P or _is_negative(s):
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 % P * u1) - u2_sqr) % P
    was_square, invsqrt = _sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = _abs(2 * s % P * den_x % P)
    y = u1 * den_y % P
    t = x * y % P
    if not was_square or _is_negative(t) or y == 0:
        return None
    return (x, y, 1, t)


def encode(p) -> bytes:
    """Extended point -> canonical 32-byte ristretto string
    (RFC 9496 §4.3.2)."""
    x0, y0, z0, t0 = p
    u1 = (z0 + y0) % P * ((z0 - y0) % P) % P
    u2 = x0 * y0 % P
    _, invsqrt = _sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * t0 % P
    ix0 = x0 * SQRT_M1 % P
    iy0 = y0 * SQRT_M1 % P
    enchanted = den1 * INVSQRT_A_MINUS_D % P
    rotate = _is_negative(t0 * z_inv % P)
    if rotate:
        x, y, den_inv = iy0, ix0, enchanted
    else:
        x, y, den_inv = x0, y0, den2
    if _is_negative(x * z_inv % P):
        y = (-y) % P
    s = _abs(den_inv * ((z0 - y) % P) % P)
    return s.to_bytes(32, "little")


def eq(p, q) -> bool:
    """Ristretto equality (RFC 9496 §4.5): cosets compare equal."""
    x1, y1, _, _ = p
    x2, y2, _, _ = q
    return (x1 * y2 - y1 * x2) % P == 0 or \
        (y1 * y2 - x1 * x2) % P == 0


BASEPOINT = ed.B                     # same generator as edwards25519
add = ed.point_add
mul = ed.point_mul
neg = ed.point_neg
IDENTITY = (0, 1, 1, 0)
