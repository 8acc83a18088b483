"""Keccak-f[1600], STROBE-128 and Merlin transcripts: the transcript
machinery under sr25519 (schnorrkel) — the port's own copy of
`cometbft_tpu.crypto.strobe`.

Implemented from the specs (FIPS 202 permutation; STROBE v1.0.2 as
merlin's strobe.rs specializes it; the Merlin transcript protocol).
merlin's transcript equivalence-test vector pins the whole stack
(tests/test_torch_sr25519.py).  Pure Python, on the host.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# keccak-f[1600]
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rho rotation offsets and pi lane permutation, derived per FIPS 202
_ROTC = [[0] * 5 for _ in range(5)]
_x, _y = 1, 0
for _t in range(24):
    _ROTC[_x][_y] = ((_t + 1) * (_t + 2) // 2) % 64
    _x, _y = _y, (2 * _x + 3 * _y) % 5


def _rol(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK64


def keccak_f1600(lanes: list[int]) -> list[int]:
    """In-place permutation over 25 64-bit lanes (x + 5y indexing)."""
    a = lanes
    for rnd in range(24):
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(
                    a[x + 5 * y], _ROTC[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ (
                    (~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]
                ) & _MASK64
        # iota
        a[0] ^= _RC[rnd]
    return a


def _keccak_bytes(state: bytearray) -> None:
    lanes = [int.from_bytes(state[8 * i:8 * i + 8], "little")
             for i in range(25)]
    keccak_f1600(lanes)
    for i, lane in enumerate(lanes):
        state[8 * i:8 * i + 8] = lane.to_bytes(8, "little")


# ---------------------------------------------------------------------------
# STROBE-128 (merlin's specialization, strobe.rs)
# ---------------------------------------------------------------------------

STROBE_R = 166

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        _keccak_bytes(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- duplex ------------------------------------------------------------

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        _keccak_bytes(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if self.cur_flags != flags:
                raise ValueError("STROBE op flag mismatch on continuation")
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if (flags & (FLAG_C | FLAG_K)) and self.pos != 0:
            self._run_f()

    # -- merlin's op subset ------------------------------------------------

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool = False) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool = False) -> None:
        """Rekey (KEY op).  Unused by our transcript consumers (the
        deterministic sr25519 witness uses clone+append instead of
        merlin's TranscriptRng), kept for STROBE-op completeness."""
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)


# ---------------------------------------------------------------------------
# merlin transcript
# ---------------------------------------------------------------------------

def _le32(n: int) -> bytes:
    return n.to_bytes(4, "little")


class Transcript:
    """merlin::Transcript."""

    def __init__(self, label: bytes):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def clone(self) -> "Transcript":
        t = Transcript.__new__(Transcript)
        t.strobe = Strobe128.__new__(Strobe128)
        t.strobe.state = bytearray(self.strobe.state)
        t.strobe.pos = self.strobe.pos
        t.strobe.pos_begin = self.strobe.pos_begin
        t.strobe.cur_flags = self.strobe.cur_flags
        return t

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, value: int) -> None:
        self.append_message(label, value.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(n), True)
        return self.strobe.prf(n)
