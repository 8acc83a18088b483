"""BitArray: vote presence tracking for gossip (the port's copy of
`cometbft_tpu.libs.bits`; CometBFT internal/bits/bit_array.go).

Backed by a numpy bool array: `sub`, `or`, `not` and pick-random are
vector ops, as the gossip routines use BitArrays to compute "votes the
peer is missing" set differences.
"""

from __future__ import annotations

import random

import numpy as np

from . import protowire as pw

# Upper bound for wire-decoded sizes: generous for both vote sets
# (MaxVotesCount=10000) and block part sets (100MiB / 64KiB parts)
MAX_PROTO_BITS = 1 << 22


class BitArray:
    __slots__ = ("bits",)

    def __init__(self, n: int = 0):
        self.bits = np.zeros(max(n, 0), dtype=bool)

    @staticmethod
    def from_bools(vals) -> "BitArray":
        ba = BitArray(0)
        ba.bits = np.asarray(list(vals), dtype=bool)
        return ba

    def size(self) -> int:
        return int(self.bits.shape[0])

    def __len__(self) -> int:
        return self.size()

    def get_index(self, i: int) -> bool:
        if i < 0 or i >= self.size():
            return False
        return bool(self.bits[i])

    def set_index(self, i: int, v: bool) -> bool:
        if i < 0 or i >= self.size():
            return False
        self.bits[i] = v
        return True

    def copy(self) -> "BitArray":
        ba = BitArray(0)
        ba.bits = self.bits.copy()
        return ba

    def or_(self, other: "BitArray") -> "BitArray":
        """Union, sized to the larger operand (bit_array.go Or)."""
        n = max(self.size(), other.size())
        ba = BitArray(n)
        ba.bits[:self.size()] = self.bits
        ba.bits[:other.size()] |= other.bits
        return ba

    def and_(self, other: "BitArray") -> "BitArray":
        n = min(self.size(), other.size())
        ba = BitArray(0)
        ba.bits = self.bits[:n] & other.bits[:n]
        return ba

    def not_(self) -> "BitArray":
        ba = BitArray(0)
        ba.bits = ~self.bits
        return ba

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other; result sized as self
        (bit_array.go Sub)."""
        ba = self.copy()
        n = min(self.size(), other.size())
        ba.bits[:n] &= ~other.bits[:n]
        return ba

    def is_empty(self) -> bool:
        return not bool(self.bits.any())

    def is_full(self) -> bool:
        return bool(self.bits.all()) if self.size() else True

    def pick_random(self) -> tuple[int, bool]:
        """A uniformly random set index (bit_array.go PickRandom)."""
        idxs = np.flatnonzero(self.bits)
        if idxs.size == 0:
            return 0, False
        return int(random.choice(idxs)), True

    def true_indices(self) -> list[int]:
        return [int(i) for i in np.flatnonzero(self.bits)]

    def num_true(self) -> int:
        return int(self.bits.sum())

    def update(self, other: "BitArray") -> None:
        """Copy other's bits into self (bit_array.go Update)."""
        n = min(self.size(), other.size())
        self.bits[:n] = other.bits[:n]

    def __eq__(self, other) -> bool:
        if not isinstance(other, BitArray):
            return NotImplemented
        return self.size() == other.size() and bool(
            (self.bits == other.bits).all())

    def __str__(self) -> str:
        return "BA{%d:%s}" % (
            self.size(),
            "".join("x" if b else "_" for b in self.bits))

    # proto: message BitArray { int64 bits = 1; repeated uint64 elems = 2; }
    def to_proto(self) -> bytes:
        n = self.size()
        padded = np.zeros(-(-n // 64) * 64, dtype=bool)
        padded[:n] = self.bits
        elems = [int(w) for w in np.packbits(
            padded, bitorder="little").view("<u8")]
        wtr = pw.Writer().int_field(1, n)
        if elems:
            wtr.packed_uint64_field(2, elems)
        return wtr.bytes()

    @staticmethod
    def from_proto(payload: bytes) -> "BitArray":
        r = pw.Reader(payload)
        n, elems = 0, []
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                n = r.read_int()
            elif f == 2 and w == pw.BYTES:
                elems = r.read_packed_uint64()
            elif f == 2 and w == pw.VARINT:
                elems.append(r.read_uvarint() & pw.MASK64)
            else:
                r.skip(w)
        # DoS bound: the declared size is attacker-controlled gossip input
        if n < 0 or n > MAX_PROTO_BITS:
            raise ValueError(f"BitArray size {n} out of range")
        words = np.array(elems, dtype=np.uint64)
        unpacked = np.unpackbits(
            words.view(np.uint8), bitorder="little")
        ba = BitArray(n)
        m = min(n, unpacked.shape[0])
        ba.bits[:m] = unpacked[:m].astype(bool)
        return ba
