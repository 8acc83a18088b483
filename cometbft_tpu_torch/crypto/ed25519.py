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
from dataclasses import dataclass

import numpy as np

from ..libs import lockrank
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


def _recode_w5(values, ndig: int, width: int):
    """Signed radix-32 recoding: each value becomes ndig digits in
    [-16, 15], emitted MSB-first as magnitude (int32) and sign (bool)
    arrays of shape (ndig, width); pad columns stay zero.

    Vectorized via the bias trick: the signed digits of x are the plain
    base-32 digits of x + BIAS minus 16, BIAS = sum_j 16*32**j.
    `values` is a list of ints or an (n, _recode_nbytes(ndig)) uint8
    array of little-endian bytes (the device-hash packer's z block)."""
    n = len(values)
    mag = np.zeros((width, ndig), np.int32)
    neg = np.zeros((width, ndig), bool)
    if n:
        nbytes = _recode_nbytes(ndig)
        if isinstance(values, np.ndarray):
            assert values.shape == (n, nbytes) and values.dtype == np.uint8
            raw = values.astype(np.uint16)
        else:
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
    128 MiB) and an entry cap.  Thread-safe: its lock has the rank name
    "ed25519.atable" (libs/lockrank)."""

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
        self._lock = lockrank.RankedLock("ed25519.atable")
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


# ---------------------------------------------------------------------------
# device-side hash-to-scalar packing
# ---------------------------------------------------------------------------
#
# The device-hash program (ops/ed25519.rlc_verify_hash_kernel) computes
# h = SHA512(R||A||M) mod L, zh = z*h, the per-pubkey aggregation AND
# the signed-window recode on the card; the host's per-signature work
# shrinks to a structural parse plus one columnar message pad.  No
# digest or scalar crosses back to the host.


def device_hash_enabled() -> bool:
    """COMETBFT_TPU_DEVICE_HASH=1 sends the verify pipeline's windows
    down the device-hash path (crypto/dispatch.py).  Read on every call,
    so tests and operators can flip it without a reload."""
    return os.environ.get("COMETBFT_TPU_DEVICE_HASH", "0") == "1"


# Static SHA-512 block bucket for R||A||M messages.  Vote sign-bytes
# are ~110-130 bytes; +64 for R||A and +17 of padding needs 3 blocks.
# A longer message raises ValueError("message exceeds max_blocks").
DEVICE_HASH_MAX_BLOCKS = int(os.environ.get(
    "COMETBFT_TPU_DEVICE_HASH_BLOCKS", "3"))


def parse_batch(pubkeys: list[bytes],
                sigs: list[bytes]) -> list[tuple[bytes, int] | None]:
    """Structural parse ONLY (lengths, s < L): the host side of the
    device-hash path, where parse_and_hash's hashlib loop never runs."""
    return [parse_signature(sig) if len(pk) == PUBKEY_SIZE else None
            for pk, sig in zip(pubkeys, sigs)]


def pack_rlc_device_hash(pubkeys: list[bytes], msgs: list[bytes],
                         sigs: list[bytes], parsed=None,
                         max_blocks: int | None = None):
    """Pack a batch for the device-hash RLC program, byte for byte as
    the JAX package packs it.

    `parsed` is a parse_batch result ((r_enc, s) | None per entry, no
    h).  Host work per signature: a 128-bit z draw (one block from
    `secrets`), c += z*s mod L, and the R||A||M byte splice; hashing,
    the per-pubkey zh aggregation and the A-side recode run on the
    device.  Callers that parsed ahead of time may pass placeholder
    sigs: the 64-byte rows are rebuilt from parsed's (r_enc, s).

    Returns the program's argument tuple (a_words (8,K), r_words (8,N),
    base_limbs (K,16), z_limbs (N,8), group_ids (N,), blocks_hi/lo
    (N,B,16), n_blocks (N,), r_mag/r_neg (26,N)) as numpy arrays, or
    None if any entry fails the structural checks.  Raises
    ValueError("message exceeds max_blocks") when a message outgrows
    the block bucket."""
    from ..ops import ed25519 as dev
    from ..ops import sha2

    n = len(pubkeys)
    if n == 0:
        return None
    if parsed is None:
        parsed = parse_batch(pubkeys, sigs)
    if max_blocks is None:
        max_blocks = DEVICE_HASH_MAX_BLOCKS

    zraw = np.frombuffer(secrets.token_bytes(16 * n),
                         dtype=np.uint8).reshape(n, 16).copy()
    zraw[:, 15] |= 0x80                    # pin the top bit, like pack_rlc

    if any(p is None for p in parsed):
        return None
    if len(sigs[0]) != 64:
        sigs = [r_enc + s.to_bytes(32, "little") for r_enc, s in parsed]

    # every sig is 64 bytes and every key 32 from here: the batch
    # flattens into two matrices
    nbatch = dev.pad_width(n)
    filler = np.frombuffer(_B_ENC, dtype=np.uint32)
    sig_mat = np.frombuffer(b"".join(sigs), dtype=np.uint8).reshape(n, 64)
    pk_mat = np.frombuffer(b"".join(pubkeys), dtype=np.uint8).reshape(n, 32)
    r_words = np.empty((nbatch, 8), dtype=np.uint32)
    r_words[:] = filler
    r_words[:n] = np.ascontiguousarray(sig_mat[:, :32]).view(np.uint32)

    # group ids: unique keys by a byte-comparing sort, remapped to
    # FIRST-APPEARANCE order so the slots match the host-hash packer
    pk_void = pk_mat.view(np.dtype((np.void, 32))).ravel()
    _, first_idx, inv = np.unique(pk_void, return_index=True,
                                  return_inverse=True)
    n_keys = len(first_idx)
    remap = np.empty(n_keys, dtype=np.int32)
    remap[np.argsort(first_idx)] = np.arange(n_keys, dtype=np.int32)
    group_ids = np.zeros(nbatch, dtype=np.int32)
    group_ids[:n] = remap[inv.reshape(-1)] + 1

    # c = sum(z_i * s_i) mod L as one uint16-limb convolution: column
    # sums stay under 8n * 2**32, far below 2**64
    s16 = np.ascontiguousarray(sig_mat[:, 32:]).view(np.uint16)
    z16 = zraw.view(np.uint16)
    cols = np.zeros(23, dtype=np.uint64)
    for j in range(8):
        cols[j:j + 16] += (z16[:, j:j + 1].astype(np.uint64)
                           * s16).sum(axis=0)
    c = sum(int(v) << (16 * k) for k, v in enumerate(cols)) % L

    # columnar R||A||M assembly straight into the padded block matrix
    mlens = np.fromiter((len(m) for m in msgs), dtype=np.int64, count=n)
    lens = np.zeros(nbatch, dtype=np.int64)
    lens[:n] = 64 + mlens
    if int(lens.max()) + 1 + 16 > max_blocks * 128:
        raise ValueError("message exceeds max_blocks")
    mat = np.zeros((nbatch, max_blocks * 128), dtype=np.uint8)
    mat[:n, :32] = sig_mat[:, :32]
    mat[:n, 32:64] = pk_mat
    flat = np.frombuffer(b"".join(msgs), dtype=np.uint8)
    m0 = int(mlens[0])
    if np.all(mlens == m0):
        mat[:n, 64:64 + m0] = flat.reshape(n, m0)
    else:
        colix = np.arange(max_blocks * 128, dtype=np.int64)
        mask = (colix[None, :] >= 64) & (colix[None, :] < lens[:n, None])
        mat[:n][mask] = flat
    blocks_hi, blocks_lo, n_blocks = sha2.pad_sha512_matrix(mat, lens)
    n_blocks[n:] = 0                       # fillers: z = 0 keeps them inert

    kbatch = dev.pad_width(1 + n_keys)
    a_words = np.empty((kbatch, 8), dtype=np.uint32)
    a_words[:] = filler
    a_words[0] = np.frombuffer(_NEG_B_ENC, dtype=np.uint32)
    a_words[1:1 + n_keys] = np.ascontiguousarray(
        pk_mat[np.sort(first_idx)]).view(np.uint32)
    base_limbs = np.zeros((kbatch, 16), dtype=np.uint32)
    base_limbs[0] = int_to_limbs16(c, 16)

    z_limbs = np.zeros((nbatch, 8), dtype=np.uint32)
    z_limbs[:n] = zraw[:, 0::2].astype(np.uint32) | \
        (zraw[:, 1::2].astype(np.uint32) << 8)
    zbytes = np.zeros((n, _recode_nbytes(NDIG_128)), dtype=np.uint8)
    zbytes[:, :16] = zraw
    r_mag, r_neg = _recode_w5(zbytes, NDIG_128, nbatch)
    return (np.ascontiguousarray(a_words.T),
            np.ascontiguousarray(r_words.T),
            base_limbs, z_limbs, group_ids,
            blocks_hi, blocks_lo, n_blocks, r_mag, r_neg)


def pack_batch_device_hash(pubkeys: list[bytes], msgs: list[bytes],
                           sigs: list[bytes], batch_size: int,
                           parsed=None, max_blocks: int | None = None):
    """Per-signature packing with device-side hashing, the reject
    localization of the device-hash path.

    Returns (a_words (8,B), r_words (8,B), s_limbs (16,B), blocks_hi/lo
    (B,Bk,16), n_blocks (B,), valid (B,)) numpy arrays; raises
    ValueError on an oversized message like pack_rlc_device_hash."""
    from ..ops import sha2

    n = len(pubkeys)
    assert batch_size >= n
    if parsed is None:
        parsed = parse_batch(pubkeys, sigs)
    if max_blocks is None:
        max_blocks = DEVICE_HASH_MAX_BLOCKS
    valid = np.zeros(batch_size, dtype=bool)
    a_words = np.zeros((batch_size, 8), dtype=np.uint32)
    r_words = np.zeros((batch_size, 8), dtype=np.uint32)
    s_limbs = np.zeros((batch_size, 16), dtype=np.uint32)
    hash_msgs = []
    for i in range(n):
        if parsed[i] is None:
            hash_msgs.append(b"")
            continue
        r_enc, s = parsed[i]
        valid[i] = True
        a_words[i] = np.frombuffer(pubkeys[i], dtype=np.uint32)
        r_words[i] = np.frombuffer(r_enc, dtype=np.uint32)
        s_limbs[i] = int_to_limbs16(s, 16)
        hash_msgs.append(r_enc + pubkeys[i] + msgs[i])
    blocks_hi, blocks_lo, n_blocks = sha2.pad_sha512(
        hash_msgs + [b""] * (batch_size - n), max_blocks)
    n_blocks[~valid] = 0
    filler = np.frombuffer(_B_ENC, dtype=np.uint32)
    a_words[~valid] = filler
    r_words[~valid] = filler
    return (np.ascontiguousarray(a_words.T),
            np.ascontiguousarray(r_words.T),
            np.ascontiguousarray(s_limbs.T),
            blocks_hi, blocks_lo, n_blocks, valid)


def rlc_verify_hash_async(packed, device="cuda"):
    """Copy a pack_rlc_device_hash batch to `device` and launch its
    device-hash RLC program there; returns the 0-dim bool verdict tensor
    without waiting for it (see rlc_verify_async).  No A-table cache:
    the program recodes its A scalars on the device."""
    from .. import convert
    from ..ops import device as devmod
    from ..ops import ed25519 as dev

    device = devmod.resolve(device)
    return dev.rlc_verify_hash_kernel(
        *convert.rlc_hash_from_numpy(packed, device))


def rlc_verify_hash(packed, device="cuda") -> bool:
    """rlc_verify_hash_async, then the verdict read back."""
    return bool(rlc_verify_hash_async(packed, device=device))
