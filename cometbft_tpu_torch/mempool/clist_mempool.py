"""Concurrent mempool gated by app CheckTx (the port's copy of
`cometbft_tpu.mempool.clist_mempool`; CometBFT mempool/clist_mempool.go).

An ordered map of tx-key -> MempoolTx plays the role of the reference's
concurrent linked list (Python dicts preserve insertion order with O(1)
removal); `wait_for_txs` + per-entry sequence numbers give reactors the
clist's "block until a next entry exists" semantics for gossip.

Lifecycle per tx: CheckTx -> cache dedup -> app CheckTx (code 0?) ->
insert; on every committed block `update` removes block txs and
re-checks the rest against the post-commit app state.
"""

from __future__ import annotations

import threading
import time

from ..libs import lockrank
from dataclasses import dataclass, field

from ..abci import types as at
from ..types.block import tx_hash

# config defaults (config/config.go mempool section)
DEFAULT_SIZE = 5000
DEFAULT_MAX_TXS_BYTES = 1 << 30  # 1GiB
DEFAULT_CACHE_SIZE = 10000
DEFAULT_MAX_TX_BYTES = 1024 * 1024


class MempoolError(Exception):
    pass


class ErrTxInCache(MempoolError):
    def __init__(self):
        super().__init__("tx already exists in cache")


class ErrTxTooLarge(MempoolError):
    def __init__(self, max_size: int, got: int):
        super().__init__(f"tx too large: max {max_size}, got {got}")


class ErrMempoolIsFull(MempoolError):
    def __init__(self, num_txs: int, max_txs: int,
                 txs_bytes: int, max_bytes: int):
        super().__init__(
            f"mempool is full: {num_txs}/{max_txs} txs, "
            f"{txs_bytes}/{max_bytes} bytes")


class ErrAppCheckTx(MempoolError):
    def __init__(self, code: int, log: str):
        super().__init__(f"app rejected tx: code {code} log {log!r}")
        self.code = code
        self.log = log


def tx_key(tx: bytes) -> bytes:
    return tx_hash(tx)


@dataclass
class MempoolTx:
    """mempoolTx.go: one pending tx + metadata."""
    tx: bytes
    height: int                 # height when validated
    gas_wanted: int = 0
    seq: int = 0                # insertion sequence, for gossip cursors
    senders: set = field(default_factory=set)  # peer ids that sent it


class CListMempool:
    """mempool/clist_mempool.go CListMempool."""

    def __init__(self, app_conn, height: int = 0, *,
                 size: int = DEFAULT_SIZE,
                 max_txs_bytes: int = DEFAULT_MAX_TXS_BYTES,
                 max_tx_bytes: int = DEFAULT_MAX_TX_BYTES,
                 cache_size: int = DEFAULT_CACHE_SIZE,
                 keep_invalid_txs_in_cache: bool = False,
                 recheck: bool = True,
                 pre_check=None, post_check=None):
        from .cache import LRUTxCache, NopTxCache
        self.app_conn = app_conn
        self.height = height
        self.size_limit = size
        self.max_txs_bytes = max_txs_bytes
        self.max_tx_bytes = max_tx_bytes
        self.keep_invalid_txs_in_cache = keep_invalid_txs_in_cache
        self.recheck_enabled = recheck
        self.pre_check = pre_check
        self.post_check = post_check

        self.cache = LRUTxCache(cache_size) if cache_size > 0 \
            else NopTxCache()
        self._txs: dict[bytes, MempoolTx] = {}  # insertion-ordered
        self._txs_bytes = 0
        self._next_seq = 1
        # updateMtx: exclusive during update/recheck, shared for CheckTx
        self._mtx = lockrank.RankedRLock("mempool.clist")
        self._txs_available = threading.Event()
        self._notified_txs_available = False
        self._notify_enabled = False
        # shares _mtx so notify (under _mtx) and wait (which reads the
        # tx map) cannot deadlock on two locks taken in opposite order
        self._change_cond = lockrank.RankedCondition(self._mtx)
        # optional MempoolMetrics (libs/metrics.py), assigned by the node
        self.metrics = None

    # -- locking (execution.go Commit holds this across app Commit) -------
    def lock(self) -> None:
        self._mtx.acquire()

    def unlock(self) -> None:
        self._mtx.release()

    def pre_update(self) -> None:
        pass

    def flush_app_conn(self) -> None:
        self.app_conn.flush()

    # -- introspection -----------------------------------------------------
    def size(self) -> int:
        with self._mtx:
            return len(self._txs)

    def size_bytes(self) -> int:
        with self._mtx:
            return self._txs_bytes

    def contains(self, key: bytes) -> bool:
        with self._mtx:
            return key in self._txs

    def entries(self) -> list[MempoolTx]:
        with self._mtx:
            return list(self._txs.values())

    def entries_after(self, seq: int) -> list[MempoolTx]:
        """Entries with sequence > seq — the gossip cursor primitive."""
        with self._mtx:
            return [e for e in self._txs.values() if e.seq > seq]

    # -- adding ------------------------------------------------------------
    def check_tx(self, tx: bytes, sender: str = "") -> at.CheckTxResponse:
        """CheckTx gate (clist_mempool.go:243). Synchronous: validates
        size/cache/limits, runs the app's CheckTx, inserts on code OK."""
        if len(tx) > self.max_tx_bytes:
            raise ErrTxTooLarge(self.max_tx_bytes, len(tx))
        if self.pre_check is not None:
            self.pre_check(tx)

        # The whole gate runs under the update mutex (CometBFT holds
        # updateMtx.RLock across CheckTx, clist_mempool.go:246): a tx is
        # never checked against pre-commit app state and inserted after
        # that commit's recheck, and capacity is enforced atomically.
        with self._mtx:
            if len(self._txs) >= self.size_limit or \
                    self._txs_bytes + len(tx) > self.max_txs_bytes:
                raise ErrMempoolIsFull(
                    len(self._txs), self.size_limit,
                    self._txs_bytes, self.max_txs_bytes)

            if not self.cache.push(tx):
                # record the new sender for an already-known tx
                # (clist_mempool.go:269-284)
                entry = self._txs.get(tx_key(tx))
                if entry is not None and sender:
                    entry.senders.add(sender)
                if self.metrics is not None:
                    self.metrics.already_received_txs.inc()
                raise ErrTxInCache()

            res = self.app_conn.check_tx(at.CheckTxRequest(
                tx=tx, type=at.CHECK_TX_TYPE_CHECK))
            self._handle_check_tx_response(tx, res, sender)
        return res

    def _handle_check_tx_response(self, tx: bytes, res: at.CheckTxResponse,
                                  sender: str) -> None:
        post_ok = True
        if self.post_check is not None:
            try:
                self.post_check(tx, res)
            except Exception:
                post_ok = False
        if res.code != at.CODE_TYPE_OK or not post_ok:
            if not self.keep_invalid_txs_in_cache:
                self.cache.remove(tx)
            if self.metrics is not None:
                self.metrics.failed_txs.inc()
            raise ErrAppCheckTx(res.code, res.log)

        with self._mtx:
            key = tx_key(tx)
            if key in self._txs:  # raced with a concurrent CheckTx
                if sender:
                    self._txs[key].senders.add(sender)
                return
            entry = MempoolTx(tx=tx, height=self.height,
                              gas_wanted=res.gas_wanted,
                              seq=self._next_seq)
            self._next_seq += 1
            if sender:
                entry.senders.add(sender)
            self._txs[key] = entry
            self._txs_bytes += len(tx)
        self._notify_txs_available()
        if self.metrics is not None:
            self.metrics.tx_size_bytes.observe(len(tx))
            self._update_gauges()
        with self._change_cond:
            self._change_cond.notify_all()

    # -- consuming ---------------------------------------------------------
    def reap_max_bytes_max_gas(self, max_bytes: int,
                               max_gas: int) -> list[bytes]:
        """Txs for a proposal, insertion order, bounded by total proto
        size and gas (clist_mempool.go:503)."""
        with self._mtx:
            total_bytes = 0
            total_gas = 0
            out: list[bytes] = []
            for entry in self._txs.values():
                # amino/proto overhead per tx (types/tx.go ComputeProtoSizeForTxs)
                tx_size = _proto_tx_overhead(len(entry.tx))
                if max_bytes > -1 and total_bytes + tx_size > max_bytes:
                    break
                if max_gas > -1 and total_gas + entry.gas_wanted > max_gas:
                    break
                total_bytes += tx_size
                total_gas += entry.gas_wanted
                out.append(entry.tx)
            return out

    def reap_max_txs(self, n: int) -> list[bytes]:
        with self._mtx:
            txs = [e.tx for e in self._txs.values()]
            return txs if n < 0 else txs[:n]

    # -- post-commit update ------------------------------------------------
    def update(self, height: int, txs: list[bytes],
               tx_results: list[at.ExecTxResult],
               pre_check=None, post_check=None) -> None:
        """Remove committed txs, then recheck what remains
        (clist_mempool.go:570). Caller must hold the mempool lock."""
        self.height = height
        self._notified_txs_available = False
        if pre_check is not None:
            self.pre_check = pre_check
        if post_check is not None:
            self.post_check = post_check

        for tx, res in zip(txs, tx_results):
            if res.code == at.CODE_TYPE_OK:
                self.cache.push(tx)  # committed: never re-admit
            elif not self.keep_invalid_txs_in_cache:
                self.cache.remove(tx)
            self._remove_tx(tx_key(tx))

        if self._txs and self.recheck_enabled:
            n_recheck = len(self._txs)
            self._recheck_txs()
            if self.metrics is not None:
                self.metrics.recheck_times.inc(n_recheck)
        if self._txs:
            self._notify_txs_available()
        self._update_gauges()

    def _remove_tx(self, key: bytes) -> None:
        with self._mtx:
            entry = self._txs.pop(key, None)
            if entry is not None:
                self._txs_bytes -= len(entry.tx)

    def _update_gauges(self) -> None:
        if self.metrics is not None:
            self.metrics.size.set(self.size())
            self.metrics.size_bytes.set(self.size_bytes())

    def remove_tx_by_key(self, key: bytes) -> None:
        self._remove_tx(key)

    def _recheck_txs(self) -> None:
        """Re-run CheckTx(RECHECK) for every pending tx against the
        post-commit app state (clist_mempool.go:634)."""
        for entry in self.entries():
            res = self.app_conn.check_tx(at.CheckTxRequest(
                tx=entry.tx, type=at.CHECK_TX_TYPE_RECHECK))
            post_ok = True
            if self.post_check is not None:
                try:
                    self.post_check(entry.tx, res)
                except Exception:
                    post_ok = False
            if res.code != at.CODE_TYPE_OK or not post_ok:
                self._remove_tx(tx_key(entry.tx))
                if not self.keep_invalid_txs_in_cache:
                    self.cache.remove(entry.tx)

    def flush(self) -> None:
        """Drop everything (used by rpc unsafe_flush_mempool)."""
        with self._mtx:
            self._txs.clear()
            self._txs_bytes = 0
            self.cache.reset()

    # -- consensus notification -------------------------------------------
    def enable_txs_available(self) -> None:
        self._notify_enabled = True

    def txs_available(self) -> threading.Event:
        """Event set at most once per height when txs exist
        (mempool.go TxsAvailable)."""
        return self._txs_available

    def _notify_txs_available(self) -> None:
        if not self._notify_enabled or self._notified_txs_available:
            return
        if self.size() > 0:
            self._notified_txs_available = True
            self._txs_available.set()

    def reset_txs_available(self) -> None:
        self._txs_available.clear()

    def wait_for_txs(self, after_seq: int, timeout: float | None = None
                     ) -> bool:
        """Block until an entry with seq > after_seq exists (the clist
        front-wait used by gossip routines).

        The wait sits in a predicate loop: a notify for an unrelated
        change (or a spurious wakeup) must re-check and keep waiting
        with the REMAINING timeout, not report the raw wait() verdict
        (check_concurrency rule C2)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._change_cond:
            while not self.entries_after(after_seq):
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._change_cond.wait(remaining)
            return True


def _proto_tx_overhead(n: int) -> int:
    from ..libs.protowire import delimited_field_size
    return delimited_field_size(n)


class NopMempool:
    """mempool/nop_mempool.go: for apps that disable the mempool."""

    def check_tx(self, tx, sender=""):
        raise MempoolError("mempool is disabled")

    def size(self):
        return 0

    def size_bytes(self):
        return 0

    def reap_max_bytes_max_gas(self, max_bytes, max_gas):
        return []

    def reap_max_txs(self, n):
        return []

    def update(self, *a, **k):
        pass

    def lock(self):
        pass

    def unlock(self):
        pass

    def pre_update(self):
        pass

    def flush_app_conn(self):
        pass

    def flush(self):
        pass

    def enable_txs_available(self):
        pass

    def txs_available(self):
        import threading as _t
        return _t.Event()
