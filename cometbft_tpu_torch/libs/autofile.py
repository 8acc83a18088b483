"""Rolling file groups for the consensus WAL (the port's copy of
`cometbft_tpu.libs.autofile`; CometBFT internal/autofile/group.go).

A Group is a head file `path` plus rolled chunks `path.000`, `path.001`,
... Writes land in the head; when the head exceeds `head_size_limit` it
is rotated to the next index. Total size is bounded by dropping the
oldest chunks. Readers iterate chunks oldest -> head.
"""

from __future__ import annotations

import os
import re

from . import lockrank


class Group:
    def __init__(self, head_path: str,
                 head_size_limit: int = 10 * 1024 * 1024,
                 total_size_limit: int = 1024 * 1024 * 1024):
        self.head_path = head_path
        self.head_size_limit = head_size_limit
        self.total_size_limit = total_size_limit
        self._mtx = lockrank.RankedRLock("autofile")
        os.makedirs(os.path.dirname(head_path) or ".", exist_ok=True)
        self._head = open(head_path, "ab")
        self._min_index, self._max_index = self._scan_indexes()

    # -- index bookkeeping -------------------------------------------------

    def _scan_indexes(self) -> tuple[int, int]:
        """min/max rolled-chunk indexes on disk; head is max_index+0."""
        d = os.path.dirname(self.head_path) or "."
        base = os.path.basename(self.head_path)
        pat = re.compile(re.escape(base) + r"\.(\d{3,})$")
        indexes = sorted(int(m.group(1)) for f in os.listdir(d)
                         if (m := pat.match(f)))
        if not indexes:
            return 0, 0
        return indexes[0], indexes[-1] + 1

    def _chunk_path(self, index: int) -> str:
        return f"{self.head_path}.{index:03d}"

    def min_index(self) -> int:
        with self._mtx:
            return self._min_index

    def max_index(self) -> int:
        """Index of the head chunk (rolled chunks are < max_index)."""
        with self._mtx:
            return self._max_index

    # -- writing -----------------------------------------------------------

    def write(self, data: bytes) -> None:
        with self._mtx:
            self._head.write(data)

    def flush(self) -> None:
        with self._mtx:
            self._head.flush()

    def flush_and_sync(self) -> None:
        with self._mtx:
            self._head.flush()
            os.fsync(self._head.fileno())

    def maybe_rotate(self) -> None:
        """Roll the head if over the size limit (group.go checkHeadSizeLimit)
        and enforce the total size bound by dropping oldest chunks."""
        with self._mtx:
            self._head.flush()
            if self._head.tell() < self.head_size_limit:
                return
            self.rotate_file()
            self._enforce_total_size()

    def rotate_file(self) -> None:
        with self._mtx:
            self._head.flush()
            os.fsync(self._head.fileno())
            self._head.close()
            os.rename(self.head_path, self._chunk_path(self._max_index))
            self._max_index += 1
            self._head = open(self.head_path, "ab")

    def _enforce_total_size(self) -> None:
        while True:
            total = self._head.tell()
            chunks = list(range(self._min_index, self._max_index))
            for i in chunks:
                try:
                    total += os.path.getsize(self._chunk_path(i))
                except OSError:
                    pass
            if total <= self.total_size_limit or not chunks:
                return
            try:
                os.remove(self._chunk_path(chunks[0]))
            except OSError:
                pass
            self._min_index = chunks[0] + 1

    def reopen(self) -> None:
        """Re-open the head and rescan indexes after external surgery on
        the group's files (WAL corruption repair)."""
        with self._mtx:
            try:
                self._head.close()
            except OSError:
                pass
            self._head = open(self.head_path, "ab")
            self._min_index, self._max_index = self._scan_indexes()

    # -- reading -----------------------------------------------------------

    def chunk_paths(self) -> list[str]:
        """All chunk paths oldest->newest, head last."""
        with self._mtx:
            paths = [self._chunk_path(i)
                     for i in range(self._min_index, self._max_index)]
            paths.append(self.head_path)
            return paths

    def read_all(self) -> bytes:
        self.flush()
        out = []
        for p in self.chunk_paths():
            try:
                with open(p, "rb") as f:
                    out.append(f.read())
            except FileNotFoundError:
                pass
        return b"".join(out)

    def close(self) -> None:
        with self._mtx:
            self._head.flush()
            os.fsync(self._head.fileno())
            self._head.close()
