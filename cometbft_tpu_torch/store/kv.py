"""Embedded ordered KV store (the port's copy of `cometbft_tpu.store.kv`;
the cometbft-db analog).

The reference delegates persistence to cometbft-db (goleveldb/pebble/
rocksdb). Here the seam is the same — an ordered byte-key store with
batches and range iteration — with two backends:

- MemDB: dict + sorted key list (tests, light-client in-memory store)
- SQLiteDB: sqlite3 (C library, WAL-mode) as the durable embedded
  backend; range scans map to ORDER BY over the primary key.

Keys are raw bytes and iteration is lexicographic, matching the
semantics the block/state stores rely on for ordered height scans
(reference store/db_key_layout.go).
"""

from __future__ import annotations

import bisect
import sqlite3
import struct
from typing import Iterator

from ..libs import lockrank


def be64(h: int) -> bytes:
    """Fixed-width big-endian height key segment: lexicographic KV order
    == numeric height order (reference store/db_key_layout.go v2)."""
    return struct.pack(">Q", h)


class KVStore:
    """Interface: ordered byte-keyed store."""

    def get(self, key: bytes) -> bytes | None:
        raise NotImplementedError

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def iterate(self, start: bytes = b"", end: bytes | None = None,
                reverse: bool = False) -> Iterator[tuple[bytes, bytes]]:
        """Yield (key, value) for start <= key < end, ordered."""
        raise NotImplementedError

    def write_batch(self, sets: list[tuple[bytes, bytes]],
                    deletes: list[bytes] = ()) -> None:
        """Atomic batch (reference db.Batch.WriteSync)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemDB(KVStore):
    def __init__(self):
        self._data: dict[bytes, bytes] = {}
        self._keys: list[bytes] = []
        self._lock = lockrank.RankedRLock("store.kv")

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            return self._data.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            if key not in self._data:
                bisect.insort(self._keys, key)
            self._data[key] = value

    def delete(self, key: bytes) -> None:
        with self._lock:
            if key in self._data:
                del self._data[key]
                i = bisect.bisect_left(self._keys, key)
                del self._keys[i]

    def iterate(self, start: bytes = b"", end: bytes | None = None,
                reverse: bool = False) -> Iterator[tuple[bytes, bytes]]:
        with self._lock:
            lo = bisect.bisect_left(self._keys, start)
            hi = (bisect.bisect_left(self._keys, end)
                  if end is not None else len(self._keys))
            keys = self._keys[lo:hi]
        if reverse:
            keys = reversed(keys)
        for k in keys:
            v = self.get(k)
            if v is not None:
                yield k, v

    def write_batch(self, sets, deletes=()) -> None:
        with self._lock:
            for k, v in sets:
                self.set(k, v)
            for k in deletes:
                self.delete(k)


class SQLiteDB(KVStore):
    """Durable backend over sqlite3 in WAL mode.

    sqlite's B-tree gives ordered scans over the BLOB primary key; WAL
    mode gives atomic batch commits with one fsync, which is the
    durability model the reference gets from goleveldb's write batches.
    """

    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = lockrank.RankedRLock("store.kv")
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            # FULL: every COMMIT fsyncs the sqlite WAL — the durability the
            # block/state stores assume (reference db.Batch.WriteSync);
            # NORMAL would defer fsync to checkpoints and could lose
            # acknowledged blocks on power failure.
            self._conn.execute("PRAGMA synchronous=FULL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv "
                "(k BLOB PRIMARY KEY, v BLOB NOT NULL) WITHOUT ROWID")
            self._conn.commit()

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return row[0] if row else None

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO kv (k, v) VALUES (?, ?) "
                "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                (key, value))
            self._conn.commit()

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE k = ?", (key,))
            self._conn.commit()

    def iterate(self, start: bytes = b"", end: bytes | None = None,
                reverse: bool = False) -> Iterator[tuple[bytes, bytes]]:
        order = "DESC" if reverse else "ASC"
        if end is None:
            q = f"SELECT k, v FROM kv WHERE k >= ? ORDER BY k {order}"
            args: tuple = (start,)
        else:
            q = (f"SELECT k, v FROM kv WHERE k >= ? AND k < ? "
                 f"ORDER BY k {order}")
            args = (start, end)
        with self._lock:
            rows = self._conn.execute(q, args).fetchall()
        for k, v in rows:
            yield bytes(k), bytes(v)

    def write_batch(self, sets, deletes=()) -> None:
        with self._lock:
            cur = self._conn.cursor()
            cur.executemany(
                "INSERT INTO kv (k, v) VALUES (?, ?) "
                "ON CONFLICT(k) DO UPDATE SET v = excluded.v", list(sets))
            if deletes:
                cur.executemany("DELETE FROM kv WHERE k = ?",
                                [(k,) for k in deletes])
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def open_db(backend: str, path: str | None = None) -> KVStore:
    """Backend factory (config storage.db_backend analog)."""
    if backend in ("mem", "memdb", "memory"):
        return MemDB()
    if backend in ("sqlite", "sqlite3", "goleveldb", "pebbledb"):
        if path is None:
            raise ValueError(f"backend {backend} requires a path")
        return SQLiteDB(path)
    raise ValueError(f"unknown db backend {backend!r}")
