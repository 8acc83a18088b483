"""Host-side Ed25519 API of the port: keys, parsing, the RLC and
per-signature packers, the device-resident A-table cache and the RLC
dispatch — the counterpart of `cometbft_tpu.crypto.ed25519`.

Keys sign and verify singly with the pure-Python reference
(crypto/ed25519_ref.py); the port imports nothing beyond torch, numpy
and the standard library.  The packers return the JAX package's numpy
arrays byte for byte (convert.py turns them into tensors).
"""

from __future__ import annotations

import collections
import hashlib
import os
import secrets
import threading
from dataclasses import dataclass

import numpy as np

from . import ed25519_ref as ref

KEY_TYPE = "ed25519"
PUBKEY_SIZE = 32
PRIVKEY_SIZE = 64          # seed || pubkey, like the golang layout
SIGNATURE_SIZE = 64
L = ref.L


@dataclass(frozen=True)
class PubKey:
    data: bytes

    def __post_init__(self):
        if len(self.data) != PUBKEY_SIZE:
            raise ValueError("ed25519 pubkey must be 32 bytes")

    def type(self) -> str:
        return KEY_TYPE

    def bytes(self) -> bytes:
        return self.data

    def address(self) -> bytes:
        """First 20 bytes of SHA-256, CometBFT's address rule."""
        return hashlib.sha256(self.data).digest()[:20]

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        """Single ZIP-215 verify (pure Python)."""
        return ref.verify(self.data, msg, sig)

    def __bytes__(self):
        return self.data


@dataclass(frozen=True)
class PrivKey:
    data: bytes              # seed(32) || pubkey(32)

    def __post_init__(self):
        if len(self.data) != PRIVKEY_SIZE:
            raise ValueError("ed25519 privkey must be 64 bytes")

    @staticmethod
    def generate(seed: bytes | None = None) -> "PrivKey":
        seed, pub = ref.keygen(seed)
        return PrivKey(seed + pub)

    def type(self) -> str:
        return KEY_TYPE

    def bytes(self) -> bytes:
        return self.data

    def pub_key(self) -> PubKey:
        return PubKey(self.data[32:])

    def sign(self, msg: bytes) -> bytes:
        """RFC 8032 signature (pure Python, variable-time: tools and
        tests only)."""
        return ref.sign(self.data[:32], msg)


def parse_signature(sig: bytes) -> tuple[bytes, int] | None:
    """Split sig into (R_enc, s) and range-check s < L (RFC 8032 / ZIP-215)."""
    if len(sig) != SIGNATURE_SIZE:
        return None
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return None
    return sig[:32], s


def parse_and_hash(pubkeys: list[bytes], msgs: list[bytes],
                   sigs: list[bytes]) -> list[tuple[bytes, int, int] | None]:
    """Structural parse + hash, once per batch: for each entry
    (r_enc, s, h = SHA512(R||A||M) mod L) or None on a structural
    reject.  Both packings build from this."""
    out = []
    for pk, msg, sig in zip(pubkeys, msgs, sigs):
        parsed = parse_signature(sig) if len(pk) == PUBKEY_SIZE else None
        if parsed is None:
            out.append(None)
            continue
        r_enc, s = parsed
        h = int.from_bytes(
            hashlib.sha512(r_enc + pk + msg).digest(), "little") % L
        out.append((r_enc, s, h))
    return out


def int_to_limbs16(x: int, n: int) -> np.ndarray:
    """Python int -> n uint32 limbs of 16 bits, little-endian."""
    return np.frombuffer(x.to_bytes(2 * n, "little"),
                         dtype="<u2").astype(np.uint32)


def pack_batch(pubkeys: list[bytes], msgs: list[bytes], sigs: list[bytes],
               batch_size: int, parsed=None):
    """Pack a batch for the per-signature kernel: limbs-first
    (a_words (8,B), r_words (8,B), s_limbs (16,B), h_limbs (16,B),
    valid (B,)).  Structural rejects get valid=False and benign filler
    (the base point) so the kernel stays branch-free."""
    n = len(pubkeys)
    assert batch_size >= n
    if parsed is None:
        parsed = parse_and_hash(pubkeys, msgs, sigs)
    valid = np.zeros(batch_size, dtype=bool)
    a_words = np.zeros((batch_size, 8), dtype=np.uint32)
    r_words = np.zeros((batch_size, 8), dtype=np.uint32)
    s_limbs = np.zeros((batch_size, 16), dtype=np.uint32)
    h_limbs = np.zeros((batch_size, 16), dtype=np.uint32)
    for i in range(n):
        if parsed[i] is None:
            continue
        r_enc, s, h = parsed[i]
        valid[i] = True
        a_words[i] = np.frombuffer(pubkeys[i], dtype=np.uint32)
        r_words[i] = np.frombuffer(r_enc, dtype=np.uint32)
        s_limbs[i] = int_to_limbs16(s, 16)
        h_limbs[i] = int_to_limbs16(h, 16)
    filler = np.frombuffer(ref.point_compress(ref.B), dtype=np.uint32)
    a_words[~valid] = filler
    r_words[~valid] = filler
    return (np.ascontiguousarray(a_words.T),
            np.ascontiguousarray(r_words.T),
            np.ascontiguousarray(s_limbs.T),
            np.ascontiguousarray(h_limbs.T), valid)


NDIG_128 = 26       # signed-5-bit digits covering 128-bit z (+carry)
NDIG_256 = 52       # covering scalars < L (253 bits, +carry)


def _recode_nbytes(ndig: int) -> int:
    """Little-endian byte width of _recode_w5's raw input rows."""
    return (5 * ndig + 7) // 8 + 1


def _recode_w5_scalar(values: list[int], ndig: int, width: int):
    """One value and one digit at a time (LSB-up carry sweep): the oracle
    `_recode_w5` is held against."""
    mag = np.zeros((width, ndig), np.int32)
    neg = np.zeros((width, ndig), bool)
    for i, v in enumerate(values):
        assert v < 1 << (5 * ndig), \
            "scalar out of range for recoding width"
        digs = [(v >> (5 * j)) & 31 for j in range(ndig)]
        carry = 0
        for j in range(ndig):
            d = digs[j] + carry
            carry = 1 if d > 15 else 0
            digs[j] = d - 32 if d > 15 else d
        assert carry == 0, "scalar out of range for recoding width"
        mag[i] = [abs(d) for d in digs]
        neg[i] = [d < 0 for d in digs]
    return (np.ascontiguousarray(mag.T[::-1]),
            np.ascontiguousarray(neg.T[::-1]))


def _recode_w5(values: list[int], ndig: int, width: int):
    """Signed radix-32 recoding: each value becomes ndig digits in
    [-16, 15], emitted MSB-first as magnitude (int32) and sign (bool)
    arrays of shape (ndig, width); pad columns stay zero.

    Vectorized via the bias trick: the signed digits of x are the plain
    base-32 digits of x + BIAS minus 16, BIAS = sum_j 16*32**j."""
    n = len(values)
    mag = np.zeros((width, ndig), np.int32)
    neg = np.zeros((width, ndig), bool)
    if n:
        nbytes = _recode_nbytes(ndig)
        assert max(values) < 1 << (5 * ndig), \
            "scalar out of range for recoding width"
        raw = np.frombuffer(
            b"".join(v.to_bytes(nbytes, "little") for v in values),
            dtype=np.uint8).reshape(n, nbytes).astype(np.uint16)
        bias = np.frombuffer(
            sum(16 << (5 * j) for j in range(ndig)).to_bytes(
                nbytes, "little"), dtype=np.uint8).astype(np.uint16)
        acc = raw + bias                      # per-byte sums < 2**9
        carry = np.zeros(n, np.uint16)
        for k in range(nbytes):
            t = acc[:, k] + carry
            acc[:, k] = t & 0xFF
            carry = t >> 8
        assert not carry.any(), "scalar out of range for recoding width"
        digs = np.empty((n, ndig), np.int16)
        for j in range(ndig):
            off = 5 * j
            k, sh = off >> 3, off & 7
            word = acc[:, k] | (acc[:, k + 1] << 8)
            digs[:, j] = (((word >> sh) & 31).astype(np.int16)) - 16
        mag[:n] = np.abs(digs)
        neg[:n] = digs < 0
    return (np.ascontiguousarray(mag.T[::-1]),
            np.ascontiguousarray(neg.T[::-1]))


def _neg_b_encoding() -> bytes:
    """Compressed -B: flip the x-sign bit of the base point encoding."""
    enc = bytearray(ref.point_compress(ref.B))
    enc[31] ^= 0x80
    return bytes(enc)


_NEG_B_ENC = _neg_b_encoding()
_B_ENC = ref.point_compress(ref.B)


def pack_rlc(pubkeys: list[bytes], msgs: list[bytes], sigs: list[bytes],
             parsed=None, z=None):
    """Pack a batch for the RLC program (ops/ed25519.rlc_verify_kernel).

    Per signature: h = SHA512(R||A||M) mod L (parse_and_hash), a 128-bit
    weight z with its top bit set, zh = z*h mod L.  Repeated pubkeys
    aggregate (the A-side MSM runs over DISTINCT keys, in first-seen
    order); the fixed-base term c = sum z_i*s_i mod L rides in A slot 0
    as (-B, c); both sides pad to ops/ed25519.pad_width with the base
    point at zero scalar; scalars are recoded into signed 5-bit digits.

    z: None draws each weight from `secrets` (RLC soundness needs them
    unpredictable); an iterable of ints supplies them instead (tests feed
    both packages the same weights).

    Returns (a_words (8,K), r_words (8,N), a_mag (52,K), a_neg (52,K),
    r_mag (26,N), r_neg (26,N)) numpy arrays, limbs-first/MSB-first, or
    None if any entry fails the structural checks.
    """
    from ..ops import ed25519 as dev

    n = len(pubkeys)
    if n == 0:
        return None
    if parsed is None:
        parsed = parse_and_hash(pubkeys, msgs, sigs)
    zs_in = None if z is None else iter(z)
    agg: dict[bytes, int] = {}
    c = 0
    r_encs = []
    zs = []
    for i in range(n):
        if parsed[i] is None:
            return None
        r_enc, s, h = parsed[i]
        zi = (secrets.randbits(128) if zs_in is None
              else next(zs_in)) | (1 << 127)
        pk = pubkeys[i]
        agg[pk] = (agg.get(pk, 0) + zi * h) % L
        c = (c + zi * s) % L
        r_encs.append(r_enc)
        zs.append(zi)

    kbatch = dev.pad_width(1 + len(agg))
    nbatch = dev.pad_width(n)
    filler = np.frombuffer(_B_ENC, dtype=np.uint32)
    a_words = np.empty((kbatch, 8), dtype=np.uint32)
    r_words = np.empty((nbatch, 8), dtype=np.uint32)
    a_words[:] = filler
    r_words[:] = filler
    a_words[0] = np.frombuffer(_NEG_B_ENC, dtype=np.uint32)
    for j, pk in enumerate(agg.keys(), start=1):
        a_words[j] = np.frombuffer(pk, dtype=np.uint32)
    r_words[:n] = np.frombuffer(b"".join(r_encs),
                                dtype=np.uint32).reshape(n, 8)
    a_mag, a_neg = _recode_w5([c] + list(agg.values()), NDIG_256, kbatch)
    r_mag, r_neg = _recode_w5(zs, NDIG_128, nbatch)
    return (np.ascontiguousarray(a_words.T),
            np.ascontiguousarray(r_words.T),
            a_mag, a_neg, r_mag, r_neg)


# one cached A-table slot: 17 rows x 4 coords x 20 int32 limbs
BYTES_PER_A_SLOT = 17 * 4 * 20 * 4


class ATableCache:
    """Device cache of decompressed A-side window tables.

    A validator set's distinct pubkeys produce the same packed a_words
    every commit, so the decompression + 17-row table build (K1 + K2 on
    the A side) can stay on the card across dispatches.  Keyed by
    (a_words bytes, device): each device of a split keeps its own copy.
    LRU-bounded by a byte budget (COMETBFT_TPU_A_CACHE_BYTES, default
    128 MiB) and an entry cap.  Thread-safe."""

    # Below this many A slots the saved work is smaller than the cost of
    # keeping a table: small-K batches stay on the whole program.
    MIN_K = int(os.environ.get("COMETBFT_TPU_A_CACHE_MIN_K", "64"))

    def __init__(self, capacity: int = 128, max_bytes: int | None = None):
        self._cap = capacity
        self._max_bytes = (max_bytes if max_bytes is not None else
                           int(os.environ.get(
                               "COMETBFT_TPU_A_CACHE_BYTES",
                               str(128 << 20))))
        self._entries = collections.OrderedDict()   # key -> (entry, nbytes)
        self._bytes = 0
        self._seen: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def bytes_resident(self) -> int:
        return self._bytes

    def get(self, a_words: np.ndarray, device):
        """(8, K) packed encodings -> (device table, device ok-flag),
        built on and keyed to `device`."""
        from .. import convert
        from ..ops import ed25519 as dev

        key = (a_words.tobytes(), str(device))
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return self._entries[key][0]
        entry = dev.build_a_tables(convert.words_from_numpy(a_words, device))
        nbytes = entry[0].numel() * entry[0].element_size()
        with self._lock:
            self.misses += 1
            if nbytes > self._max_bytes:
                return entry                 # larger than the whole budget
            if key not in self._entries:
                self._entries[key] = (entry, nbytes)
                self._bytes += nbytes
                while (self._bytes > self._max_bytes
                       or len(self._entries) > self._cap):
                    _, (_, freed) = self._entries.popitem(last=False)
                    self._bytes -= freed
                    self.evictions += 1
        return entry

    def get_if_worthwhile(self, a_words: np.ndarray, device):
        """Entry if cached; else None — only the SECOND sighting of a
        large-K key builds a table (one-shot batches must not thrash the
        cache; a repeated validator set shows up identically twice)."""
        if a_words.shape[-1] < self.MIN_K:
            return None
        if a_words.shape[-1] * BYTES_PER_A_SLOT > self._max_bytes:
            return None
        key = (a_words.tobytes(), str(device))
        with self._lock:
            if key not in self._entries:
                digest = (hashlib.sha256(key[0]).digest(), key[1])
                if digest not in self._seen:
                    self._seen[digest] = True
                    while len(self._seen) > 64:
                        self._seen.popitem(last=False)
                    return None            # first sighting
        return self.get(a_words, device)


_A_TABLE_CACHE = ATableCache(
    capacity=int(os.environ.get("COMETBFT_TPU_A_CACHE_CAP", "8")))

USE_A_CACHE = os.environ.get("COMETBFT_TPU_A_CACHE", "1") == "1"


def rlc_verify_async(packed, use_cache: bool | None = None, device="cuda"):
    """Launch a pack_rlc batch's RLC program on `device` and return its
    0-dim bool verdict tensor there, without waiting for it, so that a
    caller splitting a window over several devices
    (crypto/mesh.split_rlc_verify) launches every program before it
    reads any verdict.

    use_cache: True runs the cached-A program on the set's table for
    `device` (built on a miss); False runs the whole program; None is
    the ATableCache policy (cached-A from a set's second sighting on),
    which COMETBFT_TPU_A_CACHE=0 turns off."""
    from .. import convert
    from ..ops import device as devmod
    from ..ops import ed25519 as dev

    device = devmod.resolve(device)
    a_words = np.asarray(packed[0])
    entry = None
    if use_cache is True:
        entry = _A_TABLE_CACHE.get(a_words, device)
    elif use_cache is None and USE_A_CACHE:
        entry = _A_TABLE_CACHE.get_if_worthwhile(a_words, device)
    t = convert.packed_from_numpy(packed, device)
    if entry is not None:
        return dev.rlc_verify_kernel_cached_a(entry[0], entry[1], *t[1:])
    return dev.rlc_verify_kernel(*t)


def rlc_verify(packed, use_cache: bool | None = None, device="cuda") -> bool:
    """rlc_verify_async, then the verdict read back."""
    return bool(rlc_verify_async(packed, use_cache=use_cache, device=device))
