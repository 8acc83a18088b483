"""secp256k1 ECDSA keys, the host verify, the device packers, the key-table
cache and the MSM dispatch — the port's counterpart of
`cometbft_tpu.crypto.secp256k1`.

Semantics are CometBFT's (crypto/secp256k1/secp256k1.go): 32-byte private
keys, 33-byte compressed public keys, SHA-256 ECDSA with RFC 6979 nonces,
64-byte R||S signatures in lower-S form, and verification that refuses a
signature not in lower-S form.  The address is RIPEMD160(SHA256(key)).

The port imports nothing beyond torch, numpy and the standard library,
so its one host verify is the pure-Python `_verify_py` (the JAX package
tries OpenSSL first; the accept sets are equal).  The packers return the
JAX package's numpy arrays byte for byte; convert.py turns them into
tensors.
"""

from __future__ import annotations

import collections
import hashlib
import hmac
import os
import secrets
import struct
from dataclasses import dataclass

import numpy as np

from ..libs import lockrank
from .hash import sum_sha256

KEY_TYPE = "secp256k1"
PRIVKEY_SIZE = 32
PUBKEY_SIZE = 33
SIGNATURE_SIZE = 64

# curve parameters (SEC2 2.4.1)
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


# Jacobian point arithmetic in Python integers (None = infinity);
# variable time, for public data and for the test and bench keys.

def _jadd(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    if u1 == u2:
        if s1 != s2:
            return None
        return _jdbl(p)
    h = (u2 - u1) % P
    i = 4 * h * h % P
    j = h * i % P
    r = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (r * r - j - 2 * v) % P
    y3 = (r * (v - x3) - 2 * s1 * j) % P
    z3 = 2 * h * z1 * z2 % P
    return x3, y3, z3


def _jdbl(p):
    if p is None:
        return None
    x1, y1, z1 = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = b * b % P
    d = 2 * ((x1 + b) * (x1 + b) - a - c) % P
    e = 3 * a % P
    f = e * e % P
    x3 = (f - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * y1 * z1 % P
    return x3, y3, z3


def _jmul(k: int, pt):
    """Double-and-add scalar multiplication."""
    acc = None
    add = pt
    while k:
        if k & 1:
            acc = _jadd(acc, add)
        add = _jdbl(add)
        k >>= 1
    return acc


def _jaffine(p):
    if p is None:
        return None
    x, y, z = p
    zi = _inv(z, P)
    zi2 = zi * zi % P
    return x * zi2 % P, y * zi2 * zi % P


_G = (GX, GY, 1)


def _compress(x: int, y: int) -> bytes:
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def _decompress(data: bytes) -> tuple[int, int] | None:
    if len(data) != PUBKEY_SIZE or data[0] not in (2, 3):
        return None
    x = int.from_bytes(data[1:], "big")
    if x >= P:
        return None
    y2 = (pow(x, 3, P) + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if (y & 1) != (data[0] & 1):
        y = P - y
    return x, y


def _rfc6979_k(x: int, h1: bytes) -> int:
    """RFC 6979 section 3.2 deterministic nonce for SHA-256 / secp256k1."""
    v = b"\x01" * 32
    key = b"\x00" * 32
    x_b = x.to_bytes(32, "big")
    z_b = (int.from_bytes(h1, "big") % N).to_bytes(32, "big")
    key = hmac.new(key, v + b"\x00" + x_b + z_b, hashlib.sha256).digest()
    v = hmac.new(key, v, hashlib.sha256).digest()
    key = hmac.new(key, v + b"\x01" + x_b + z_b, hashlib.sha256).digest()
    v = hmac.new(key, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(key, v, hashlib.sha256).digest()
        k = int.from_bytes(v, "big")
        if 1 <= k < N:
            return k
        key = hmac.new(key, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(key, v, hashlib.sha256).digest()


def parse_signature(sig: bytes) -> tuple[int, int] | None:
    """The one definition of the signature accept set (64-byte R||S,
    1 <= r, s < n, the lower-S rule), used by the host verify and both
    device packers."""
    if len(sig) != SIGNATURE_SIZE:
        return None
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    if not (1 <= r < N and 1 <= s < N):
        return None
    if s > N // 2:
        return None
    return r, s


def _verify_py(pub_xy: tuple[int, int], digest: bytes, r: int, s: int) -> bool:
    """Textbook ECDSA verify over the already-parsed values."""
    e = int.from_bytes(digest, "big")
    w = _inv(s, N)
    u1 = e * w % N
    u2 = r * w % N
    pt = _jadd(_jmul(u1, _G), _jmul(u2, pub_xy + (1,)))
    aff = _jaffine(pt)
    if aff is None:
        return False
    return aff[0] % N == r


# -- RIPEMD-160 (addresses) ----------------------------------------------------

_RL = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
       7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
       3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
       1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
       4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13]
_RR = [5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
       6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
       15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
       8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
       12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11]
_SL = [11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
       7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
       11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
       11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
       9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6]
_SR = [8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
       9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
       9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
       15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
       8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11]
_KL = [0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E]
_KR = [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000]
_M32 = 0xFFFFFFFF


def _rmd_f(j: int, x: int, y: int, z: int) -> int:
    if j < 16:
        return x ^ y ^ z
    if j < 32:
        return (x & y) | (~x & z)
    if j < 48:
        return ((x | ~y) & _M32) ^ z
    if j < 64:
        return (x & z) | (y & ~z)
    return x ^ ((y | ~z) & _M32)


def _rol(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _M32


def _ripemd160_py(data: bytes) -> bytes:
    """RIPEMD-160 in Python, for an OpenSSL without the legacy digest."""
    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    msg = data + b"\x80" + b"\x00" * ((55 - len(data)) % 64) + \
        struct.pack("<Q", 8 * len(data))
    for off in range(0, len(msg), 64):
        x = struct.unpack("<16I", msg[off:off + 64])
        al, bl, cl, dl, el = h
        ar, br, cr, dr, er = h
        for j in range(80):
            t = _rol((al + _rmd_f(j, bl, cl, dl) + x[_RL[j]] + _KL[j >> 4])
                     & _M32, _SL[j]) + el
            al, el, dl, cl, bl = el, dl, _rol(cl, 10), bl, t & _M32
            t = _rol((ar + _rmd_f(79 - j, br, cr, dr) + x[_RR[j]]
                      + _KR[j >> 4]) & _M32, _SR[j]) + er
            ar, er, dr, cr, br = er, dr, _rol(cr, 10), br, t & _M32
        h = [(h[1] + cl + dr) & _M32, (h[2] + dl + er) & _M32,
             (h[3] + el + ar) & _M32, (h[4] + al + br) & _M32,
             (h[0] + bl + cr) & _M32]
    return struct.pack("<5I", *h)


def ripemd160(data: bytes) -> bytes:
    try:
        return hashlib.new("ripemd160", data).digest()
    except ValueError:
        return _ripemd160_py(data)


@dataclass(frozen=True)
class PubKey:
    data: bytes

    def __post_init__(self):
        if len(self.data) != PUBKEY_SIZE:
            raise ValueError("secp256k1 pubkey must be 33 bytes")

    def type(self) -> str:
        return KEY_TYPE

    def bytes(self) -> bytes:
        return self.data

    def address(self) -> bytes:
        """RIPEMD160(SHA256(compressed pubkey))."""
        return ripemd160(sum_sha256(self.data))

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        parsed = parse_signature(sig)
        if parsed is None:
            return False
        xy = _decompress(self.data)
        if xy is None:
            return False
        return _verify_py(xy, sum_sha256(msg), *parsed)

    def __bytes__(self):
        return self.data


@dataclass(frozen=True)
class PrivKey:
    data: bytes

    def __post_init__(self):
        if len(self.data) != PRIVKEY_SIZE:
            raise ValueError("secp256k1 privkey must be 32 bytes")
        d = int.from_bytes(self.data, "big")
        if not (1 <= d < N):
            raise ValueError("secp256k1 privkey out of range")

    @staticmethod
    def generate(seed: bytes | None = None) -> "PrivKey":
        """A random key, or CometBFT's hash-to-key rule for a seed:
        k = (SHA256(seed) mod (n - 1)) + 1."""
        if seed is None:
            while True:
                raw = os.urandom(32)
                d = int.from_bytes(raw, "big")
                if 1 <= d < N:
                    return PrivKey(raw)
        d = int.from_bytes(sum_sha256(seed), "big") % (N - 1) + 1
        return PrivKey(d.to_bytes(32, "big"))

    def type(self) -> str:
        return KEY_TYPE

    def bytes(self) -> bytes:
        return self.data

    def pub_key(self) -> PubKey:
        x, y = _jaffine(_jmul(int.from_bytes(self.data, "big"), _G))
        return PubKey(_compress(x, y))

    def sign(self, msg: bytes) -> bytes:
        """64-byte R||S, lower-S, RFC 6979 nonce."""
        d = int.from_bytes(self.data, "big")
        digest = sum_sha256(msg)
        e = int.from_bytes(digest, "big")
        k = _rfc6979_k(d, digest)
        while True:
            x, _y = _jaffine(_jmul(k, _G))
            r = x % N
            s = _inv(k, N) * (e + r * d) % N
            if r and s:
                break
            k = (k + 1) % N  # vanishing r or s: probability ~2**-256
        if s > N // 2:
            s = N - s
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")


# -- device batch packing ----------------------------------------------------

def _parse_item(pk: bytes, msg: bytes, sig: bytes, decomp=None):
    """(xy, r, s, u1, u2) for one structurally valid signature, else None:
    the lower-S parse, the key decompressed (through the `decomp` memo
    when given), e = SHA-256(msg), w = s^-1, u1 = e*w, u2 = r*w mod n."""
    parsed = parse_signature(sig)
    if parsed is None:
        return None
    if decomp is None:
        xy = _decompress(pk)
    else:
        if pk not in decomp:
            decomp[pk] = _decompress(pk)
        xy = decomp[pk]
    if xy is None:
        return None
    r, s = parsed
    e = int.from_bytes(sum_sha256(msg), "big")
    w = _inv(s, N)
    return xy, r, e * w % N, r * w % N


def pack_batch(pubkeys: list[bytes], msgs: list[bytes], sigs: list[bytes],
               batch_size: int):
    """Pack an ECDSA batch for ops/secp256k1.verify_kernel (the ladder).

    Entries failing a structural check get a filler whose verdict is
    False by construction (Q = G, u1 = 1, u2 = 0, r = 0: x(G) != 0).
    Returns (qx, qy, u1_nibs, u2_nibs, r_limbs, rn_limbs, rn_valid,
    valid) in the kernel's limbs-first layouts."""
    from ..ops import fe_secp as fs

    n = len(pubkeys)
    assert batch_size >= n
    qx = np.zeros((batch_size, fs.NLIMBS), np.int32)
    qy = np.zeros((batch_size, fs.NLIMBS), np.int32)
    u1n = np.zeros((batch_size, 64), np.int32)
    u2n = np.zeros((batch_size, 64), np.int32)
    r_l = np.zeros((batch_size, fs.NLIMBS), np.int32)
    rn_l = np.zeros((batch_size, fs.NLIMBS), np.int32)
    rn_ok = np.zeros(batch_size, bool)
    valid = np.zeros(batch_size, bool)

    def nibs(v: int) -> np.ndarray:
        out = np.zeros(64, np.int32)
        for j in range(63, -1, -1):
            out[j] = v & 0xF
            v >>= 4
        return out

    gx_l = fs.int_to_limbs(GX)
    gy_l = fs.int_to_limbs(GY)
    filler_u1 = nibs(1)
    for i in range(batch_size):
        item = _parse_item(pubkeys[i], msgs[i], sigs[i]) if i < n else None
        if item is None:
            qx[i], qy[i] = gx_l, gy_l
            u1n[i] = filler_u1
            continue
        xy, r, u1, u2 = item
        qx[i] = fs.int_to_limbs(xy[0])
        qy[i] = fs.int_to_limbs(xy[1])
        u1n[i] = nibs(u1)
        u2n[i] = nibs(u2)
        r_l[i] = fs.int_to_limbs(r)
        if r + N < P:
            rn_l[i] = fs.int_to_limbs(r + N)
            rn_ok[i] = True
        valid[i] = True
    return (np.ascontiguousarray(qx.T), np.ascontiguousarray(qy.T),
            np.ascontiguousarray(u1n.T), np.ascontiguousarray(u2n.T),
            np.ascontiguousarray(r_l.T), np.ascontiguousarray(rn_l.T),
            rn_ok, valid)


# -- the MSM program ---------------------------------------------------------

def msm_enabled() -> bool:
    """The MSM program on/off switch (COMETBFT_TPU_SECP_MSM, default on;
    0 takes the ladder), read on each call."""
    return os.environ.get("COMETBFT_TPU_SECP_MSM", "1") != "0"


# distinct-key axis pad grid: bounds the table shapes the way
# ops/ed25519.bucket_size bounds batch widths
_KEY_WIDTHS = (4, 8, 16, 32, 64, 96, 128, 192, 256)


def _key_pad(k: int) -> int:
    for w in _KEY_WIDTHS:
        if k <= w:
            return w
    base = _KEY_WIDTHS[-1]
    return ((k + base - 1) // base) * base


def pack_msm_batch(pubkeys: list[bytes], msgs: list[bytes],
                   sigs: list[bytes], batch_size: int) -> dict:
    """Pack an ECDSA batch for ops/secp256k1.msm_verify_kernel.

    The same structural checks and u1, u2 as pack_batch, then
    odd-normalization (u + n where u is even: n*P is infinity, so the
    value is unchanged and u' < 2n < 2**257 stays in the window span)
    and the Joye-Tunstall odd recode (ops/msm.recode_jt).  Each pack
    draws a fresh blinding scalar t with `secrets` and ships S = t*G.

    Returns a dict: keys_x / keys_y (22, K) distinct-key coordinates (K
    padded onto _KEY_WIDTHS, fillers G), key_id (the table cache key),
    gid (B,) int32 key slot per lane, g_rows / g_neg (32, B) and q_rows
    / q_neg (52, B) odd-window digits, r_limbs / rn_limbs (22, B),
    rn_valid / valid (B,), s_pt (3, 22)."""
    from ..ops import fe_secp as fs
    from ..ops import msm
    from ..ops.secp256k1 import MSM_NG, MSM_NQ, MSM_WG, MSM_WQ

    n = len(pubkeys)
    assert batch_size >= n
    u1o = [1] * batch_size
    u2o = [1] * batch_size
    gid = np.zeros(batch_size, np.int32)
    r_l = np.zeros((batch_size, fs.NLIMBS), np.int32)
    rn_l = np.zeros((batch_size, fs.NLIMBS), np.int32)
    rn_ok = np.zeros(batch_size, bool)
    valid = np.zeros(batch_size, bool)
    key_slot: dict[bytes, int] = {}
    key_xy: list[tuple[int, int]] = []
    key_order: list[bytes] = []
    decomp: dict[bytes, tuple[int, int] | None] = {}

    for i in range(n):
        item = _parse_item(pubkeys[i], msgs[i], sigs[i], decomp)
        if item is None:
            continue
        xy, r, u1, u2 = item
        pk = pubkeys[i]
        slot = key_slot.get(pk)
        if slot is None:
            slot = key_slot[pk] = len(key_order)
            key_order.append(pk)
            key_xy.append(xy)
        gid[i] = slot
        u1o[i] = u1 if u1 & 1 else u1 + N
        u2o[i] = u2 if u2 & 1 else u2 + N
        r_l[i] = fs.int_to_limbs(r)
        if r + N < P:
            rn_l[i] = fs.int_to_limbs(r + N)
            rn_ok[i] = True
        valid[i] = True

    nk = _key_pad(max(1, len(key_order)))
    keys_x = np.zeros((nk, fs.NLIMBS), np.int32)
    keys_y = np.zeros((nk, fs.NLIMBS), np.int32)
    for k, (x, y) in enumerate(key_xy):
        keys_x[k] = fs.int_to_limbs(x)
        keys_y[k] = fs.int_to_limbs(y)
    gx_l, gy_l = fs.int_to_limbs(GX), fs.int_to_limbs(GY)
    for k in range(len(key_xy), nk):
        keys_x[k], keys_y[k] = gx_l, gy_l

    g_rows, g_neg = msm.recode_jt(u1o, MSM_WG, MSM_NG)
    q_rows, q_neg = msm.recode_jt(u2o, MSM_WQ, MSM_NQ)

    t = secrets.randbelow(N - 1) + 1
    sx, sy = _jaffine(_jmul(t, _G))
    s_pt = np.stack([fs.int_to_limbs(sx), fs.int_to_limbs(sy),
                     np.asarray(fs.ONE_LIMBS, np.int32)])

    return {
        "keys_x": np.ascontiguousarray(keys_x.T),
        "keys_y": np.ascontiguousarray(keys_y.T),
        "key_id": b"".join(key_order) + b"|%d" % nk,
        "gid": gid,
        "g_rows": g_rows, "g_neg": g_neg,
        "q_rows": q_rows, "q_neg": q_neg,
        "r_limbs": np.ascontiguousarray(r_l.T),
        "rn_limbs": np.ascontiguousarray(rn_l.T),
        "rn_valid": rn_ok, "valid": valid, "s_pt": s_pt,
    }


class QTableCache:
    """Device cache of per-key MSM window tables (K11's output).

    A validator set's distinct keys pack to the same (keys_x, keys_y)
    every commit, so the table build (52 windows x 16 odd rows a key,
    ~215 KB a key) runs once per key set and device, and later commits'
    MSM programs read the resident tables.  Keyed by (key_id, device);
    LRU-bounded by a byte budget (COMETBFT_TPU_Q_CACHE_BYTES, default
    128 MiB, ~600 keys).  Thread-safe: its lock has the rank name
    "secp256k1.qtable" (libs/lockrank).  The JAX package's metrics
    gauges count hits, misses and bytes; the port has no metrics yet,
    so the counts are attributes."""

    def __init__(self, max_bytes: int | None = None):
        self._max_bytes = (max_bytes if max_bytes is not None else
                           int(os.environ.get(
                               "COMETBFT_TPU_Q_CACHE_BYTES",
                               str(128 << 20))))
        self._entries = collections.OrderedDict()  # key -> (entry, nbytes)
        self._bytes = 0
        self._lock = lockrank.RankedLock("secp256k1.qtable")
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def bytes_resident(self) -> int:
        return self._bytes

    def get(self, key_id: bytes, keys_x, keys_y, device="cuda"):
        """(qtab, q_corr) tensors on `device` for one packed key set,
        built (and admitted) on a miss."""
        from ..ops import device as devmod
        from ..ops import secp256k1 as dev_ops

        device = devmod.resolve(device)
        key = (key_id, str(device))
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return self._entries[key][0]
        entry = dev_ops.build_q_msm_tables_device(keys_x, keys_y,
                                                  device=device)
        nbytes = entry[0].numel() * entry[0].element_size()
        with self._lock:
            self.misses += 1
            if nbytes > self._max_bytes:
                return entry                 # larger than the whole budget
            if key not in self._entries:
                self._entries[key] = (entry, nbytes)
                self._bytes += nbytes
                while self._bytes > self._max_bytes and \
                        len(self._entries) > 1:
                    _, (_, freed) = self._entries.popitem(last=False)
                    self._bytes -= freed
                    self.evictions += 1
            return self._entries[key][0]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0


_Q_CACHE: QTableCache | None = None


def q_table_cache() -> QTableCache:
    global _Q_CACHE
    if _Q_CACHE is None:
        _Q_CACHE = QTableCache()
    return _Q_CACHE


def verify_msm_async(pubkeys: list[bytes], msgs: list[bytes],
                     sigs: list[bytes], batch_size: int | None = None,
                     device="cuda"):
    """Pack, table lookup and the MSM program's launch on `device`,
    without reading the verdict back: returns (the (B,) bool verdict
    tensor on the device, the host valid mask, n).  The inputs reach the
    card without a wait (convert.secp_msm_from_numpy), so the mesh split
    (crypto/mesh.split_secp_verify) launches every chunk's program
    before it reads any verdict."""
    from ..ops import device as devmod
    from ..ops import ed25519 as ed_ops
    from ..ops import secp256k1 as dev_ops

    device = devmod.resolve(device)
    n = len(pubkeys)
    if batch_size is None:
        batch_size = ed_ops.bucket_size(n)
    pk = pack_msm_batch(pubkeys, msgs, sigs, batch_size)
    qtab, q_corr = q_table_cache().get(pk["key_id"], pk["keys_x"],
                                       pk["keys_y"], device=device)
    verdict = dev_ops.verify_batch_msm_device(qtab, q_corr, pk, device=device)
    return verdict, pk["valid"], n


def verify_msm_batch(pubkeys: list[bytes], msgs: list[bytes],
                     sigs: list[bytes], device="cuda") -> list[bool]:
    """Per-signature ECDSA verdicts through the MSM program, in
    submission order (they are per-signature already: a reject needs no
    localization round)."""
    verdict, valid, n = verify_msm_async(pubkeys, msgs, sigs, device=device)
    return (verdict.cpu().numpy() & valid)[:n].tolist()
