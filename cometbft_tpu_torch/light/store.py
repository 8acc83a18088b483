"""Trusted light-block stores (the port's copy of
`cometbft_tpu.light.store`).

MemoryStore keeps blocks in a dict; FileStore writes each LightBlock's
proto bytes to one fsync'd file per height, `lb_<height:020d>.bin`, the
JAX package's layout, so either package reads the other's store.
"""

from __future__ import annotations

import os
from typing import Protocol

from .types import LightBlock


class Store(Protocol):
    def save_light_block(self, lb: LightBlock) -> None: ...
    def light_block(self, height: int) -> LightBlock | None: ...
    def light_block_before(self, height: int) -> LightBlock | None: ...
    def latest_light_block(self) -> LightBlock | None: ...
    def first_light_block(self) -> LightBlock | None: ...
    def delete_light_blocks_before(self, height: int) -> int: ...
    def prune(self, size: int) -> None: ...
    def size(self) -> int: ...


class MemoryStore:
    def __init__(self):
        self._blocks: dict[int, LightBlock] = {}

    def save_light_block(self, lb: LightBlock) -> None:
        self._blocks[lb.height] = lb

    def light_block(self, height: int) -> LightBlock | None:
        return self._blocks.get(height)

    def light_block_before(self, height: int) -> LightBlock | None:
        """The highest stored block strictly below height."""
        below = [h for h in self._blocks if h < height]
        return self._blocks[max(below)] if below else None

    def latest_light_block(self) -> LightBlock | None:
        return self._blocks[max(self._blocks)] if self._blocks else None

    def first_light_block(self) -> LightBlock | None:
        return self._blocks[min(self._blocks)] if self._blocks else None

    def delete_light_blocks_before(self, height: int) -> int:
        gone = [h for h in self._blocks if h < height]
        for h in gone:
            del self._blocks[h]
        return len(gone)

    def prune(self, size: int) -> None:
        """Drop the oldest blocks until `size` remain."""
        while len(self._blocks) > size:
            del self._blocks[min(self._blocks)]

    def size(self) -> int:
        return len(self._blocks)


class FileStore:
    """One proto file per height: <dir>/lb_<height:020d>.bin."""

    def __init__(self, dir_path: str):
        self._dir = dir_path
        os.makedirs(dir_path, exist_ok=True)

    def _path(self, height: int) -> str:
        return os.path.join(self._dir, f"lb_{height:020d}.bin")

    def _heights(self) -> list[int]:
        return sorted(int(name[3:-4]) for name in os.listdir(self._dir)
                      if name.startswith("lb_") and name.endswith(".bin"))

    def save_light_block(self, lb: LightBlock) -> None:
        tmp = self._path(lb.height) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(lb.to_proto())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(lb.height))

    def light_block(self, height: int) -> LightBlock | None:
        try:
            with open(self._path(height), "rb") as f:
                return LightBlock.from_proto(f.read())
        except FileNotFoundError:
            return None

    def light_block_before(self, height: int) -> LightBlock | None:
        below = [h for h in self._heights() if h < height]
        return self.light_block(max(below)) if below else None

    def latest_light_block(self) -> LightBlock | None:
        hs = self._heights()
        return self.light_block(hs[-1]) if hs else None

    def first_light_block(self) -> LightBlock | None:
        hs = self._heights()
        return self.light_block(hs[0]) if hs else None

    def delete_light_blocks_before(self, height: int) -> int:
        n = 0
        for h in self._heights():
            if h < height:
                os.remove(self._path(h))
                n += 1
        return n

    def prune(self, size: int) -> None:
        hs = self._heights()
        for h in hs[:max(0, len(hs) - size)]:
            os.remove(self._path(h))

    def size(self) -> int:
        return len(self._heights())
