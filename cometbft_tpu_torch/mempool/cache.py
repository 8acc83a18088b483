"""Tx dedup cache (the port's copy of `cometbft_tpu.mempool.cache`;
CometBFT mempool/cache.go).

LRU keyed by tx hash; bounds repeated CheckTx work for gossiped and
resubmitted transactions.
"""

from __future__ import annotations

from ..libs import lockrank
from collections import OrderedDict

from ..types.block import tx_hash


class LRUTxCache:
    """mempool/cache.go LRUTxCache."""

    def __init__(self, size: int):
        self._size = size
        self._map: OrderedDict[bytes, None] = OrderedDict()
        self._mtx = lockrank.RankedLock("mempool.cache")

    def reset(self) -> None:
        with self._mtx:
            self._map.clear()

    def push(self, tx: bytes) -> bool:
        """True if newly added; False if already present (refreshes LRU
        position either way)."""
        key = tx_hash(tx)
        with self._mtx:
            if key in self._map:
                self._map.move_to_end(key)
                return False
            self._map[key] = None
            if len(self._map) > self._size:
                self._map.popitem(last=False)
            return True

    def remove(self, tx: bytes) -> None:
        with self._mtx:
            self._map.pop(tx_hash(tx), None)

    def has(self, tx: bytes) -> bool:
        with self._mtx:
            return tx_hash(tx) in self._map


class NopTxCache:
    """cache.go NopTxCache: used when the cache is disabled."""

    def reset(self) -> None:
        pass

    def push(self, tx: bytes) -> bool:
        return True

    def remove(self, tx: bytes) -> None:
        pass

    def has(self, tx: bytes) -> bool:
        return False
