"""RFC-6962-style Merkle trees, the port's copy of
`cometbft_tpu.crypto.merkle` (CometBFT crypto/merkle/tree.go, proof.go):
leaf prefix 0x00, inner prefix 0x01, split point = the largest power of
two below n, empty tree = SHA-256 of nothing.  Roots, inclusion proofs
(`Proof`, `proofs_from_byte_slices`) and their proto codec.

hash_leaves_device hashes the leaves in one batch through
crypto/hash.sum_sha256_many (kernel K10 for 512 leaves and more); the
~n inner hashes form a log-depth tree whose inputs depend on earlier
outputs, and stay on the host.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..libs import protowire as pw

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"


def _sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def empty_hash() -> bytes:
    return _sha256(b"")


def leaf_hash(leaf: bytes) -> bytes:
    return _sha256(LEAF_PREFIX + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha256(INNER_PREFIX + left + right)


def split_point(n: int) -> int:
    """Largest power of 2 strictly less than n (tree.go getSplitPoint)."""
    if n < 1:
        raise ValueError("split_point requires n >= 1")
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def _root_from_leaf_hashes(hashes: list[bytes]) -> bytes:
    n = len(hashes)
    if n == 0:
        return empty_hash()
    if n == 1:
        return hashes[0]
    k = split_point(n)
    return inner_hash(_root_from_leaf_hashes(hashes[:k]),
                      _root_from_leaf_hashes(hashes[k:]))


def hash_from_byte_slices(items: list[bytes]) -> bytes:
    """Merkle root of arbitrary byte slices, hashed on the host."""
    return _root_from_leaf_hashes([leaf_hash(x) for x in items])


def hash_leaves_device(items: list[bytes], device="cuda") -> list[bytes]:
    """The n leaf hashes in one batch on `device` (sum_sha256_many)."""
    from .hash import sum_sha256_many
    return sum_sha256_many([LEAF_PREFIX + x for x in items], device=device)


def hash_from_byte_slices_device(items: list[bytes], device="cuda") -> bytes:
    return _root_from_leaf_hashes(hash_leaves_device(items, device=device))


@dataclass
class Proof:
    """Inclusion proof for item `index` of `total` (proof.go:28-47)."""

    total: int
    index: int
    leaf_hash: bytes
    aunts: list[bytes] = field(default_factory=list)

    def compute_root_hash(self) -> bytes | None:
        return _compute_hash_from_aunts(self.index, self.total,
                                        self.leaf_hash, self.aunts)

    def verify(self, root_hash: bytes, leaf: bytes) -> None:
        """Raises ValueError unless this proof places leaf under root."""
        if self.total < 0:
            raise ValueError("proof total must be positive")
        if self.index < 0:
            raise ValueError("proof index cannot be negative")
        if leaf_hash(leaf) != self.leaf_hash:
            raise ValueError("invalid leaf hash")
        computed = self.compute_root_hash()
        if computed != root_hash:
            raise ValueError(
                f"invalid root hash: wanted {root_hash.hex()} "
                f"got {computed.hex() if computed else None}")

    def to_proto(self) -> bytes:
        """Wire format of crypto.Proof (proto/cometbft/crypto/v1/proof.proto)."""
        w = (pw.Writer().int_field(1, self.total).int_field(2, self.index)
             .bytes_field(3, self.leaf_hash))
        for aunt in self.aunts:
            w.bytes_field(4, aunt)
        return w.bytes()

    @staticmethod
    def from_proto(payload: bytes) -> "Proof":
        r = pw.Reader(payload)
        total, index, leaf, aunts = 0, 0, b"", []
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                total = r.read_int()
            elif f == 2 and w == pw.VARINT:
                index = r.read_int()
            elif f == 3 and w == pw.BYTES:
                leaf = r.read_bytes()
            elif f == 4 and w == pw.BYTES:
                aunts.append(r.read_bytes())
            else:
                r.skip(w)
        return Proof(total=total, index=index, leaf_hash=leaf, aunts=aunts)


def _compute_hash_from_aunts(index: int, total: int, leaf: bytes,
                             aunts: list[bytes]) -> bytes | None:
    if index >= total or index < 0 or total <= 0:
        return None
    if total == 1:
        if aunts:
            return None
        return leaf
    if not aunts:
        return None
    k = split_point(total)
    if index < k:
        left = _compute_hash_from_aunts(index, k, leaf, aunts[:-1])
        if left is None:
            return None
        return inner_hash(left, aunts[-1])
    right = _compute_hash_from_aunts(index - k, total - k, leaf, aunts[:-1])
    if right is None:
        return None
    return inner_hash(aunts[-1], right)


def proofs_from_byte_slices(items: list[bytes]) -> tuple[bytes, list[Proof]]:
    """Root + one proof per item (proof.go ProofsFromByteSlices)."""
    trails, root = _trails_from_leaf_hashes([leaf_hash(x) for x in items])
    proofs = [
        Proof(total=len(items), index=i, leaf_hash=t.hash,
              aunts=t.flatten_aunts())
        for i, t in enumerate(trails)
    ]
    return root.hash if root else empty_hash(), proofs


class _Node:
    __slots__ = ("hash", "parent", "left", "right")

    def __init__(self, h: bytes):
        self.hash = h
        self.parent = self.left = self.right = None

    def flatten_aunts(self) -> list[bytes]:
        out = []
        node = self
        while node.parent is not None:
            sibling = (node.parent.right if node.parent.left is node
                       else node.parent.left)
            if sibling is not None:
                out.append(sibling.hash)
            node = node.parent
        return out


def _trails_from_leaf_hashes(hashes: list[bytes]):
    n = len(hashes)
    if n == 0:
        return [], None
    if n == 1:
        node = _Node(hashes[0])
        return [node], node
    k = split_point(n)
    lefts, left_root = _trails_from_leaf_hashes(hashes[:k])
    rights, right_root = _trails_from_leaf_hashes(hashes[k:])
    root = _Node(inner_hash(left_root.hash, right_root.hash))
    root.left, root.right = left_root, right_root
    left_root.parent = right_root.parent = root
    return lefts + rights, root
