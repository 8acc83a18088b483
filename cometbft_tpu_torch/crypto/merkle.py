"""RFC-6962-style Merkle roots, the root half of
`cometbft_tpu.crypto.merkle` (CometBFT crypto/merkle/tree.go): leaf
prefix 0x00, inner prefix 0x01, split point = the largest power of two
below n, empty tree = SHA-256 of nothing.  Proofs are not ported.

hash_leaves_device hashes the leaves in one batch through
crypto/hash.sum_sha256_many (kernel K10 for 512 leaves and more); the
~n inner hashes form a log-depth tree whose inputs depend on earlier
outputs, and stay on the host.
"""

from __future__ import annotations

import hashlib

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
