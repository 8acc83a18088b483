"""Lock ranks: the part of `cometbft_tpu.libs.lockrank` the port's locks
need.

Each named lock has a declared rank (``LOCK_RANKS``, the JAX package's
numbers): lower rank = acquired FIRST (outermost).  With a checker
installed (``enable``), acquiring a lock whose rank is <= the highest
rank the thread already holds is a rank inversion: it raises
``LockRankError`` BEFORE the acquire blocks ("raise" mode), or is
recorded in ``violations()`` and the thread carries on ("warn" mode).
With no checker the cost is one module-global read and a branch ahead
of the raw lock.

A lock whose name is in ``MULTI_OK`` has many peer instances (one per
stripe): peers may nest at equal rank.  The JAX package's cross-thread
edge table and its thread- and future-leak registries serve its verify
pipeline, which the port does not have yet.
"""

from __future__ import annotations

import threading
import traceback

LOCK_RANKS: dict[str, int] = {
    "ed25519.atable": 430,
    "secp256k1.qtable": 440,
    "sigcache.global": 450,
    "sigcache.stripe": 460,
}

MULTI_OK = frozenset({"sigcache.stripe"})


class LockRankError(RuntimeError):
    """A rank inversion, raised before the offending acquire blocks,
    with the locks the thread holds."""


_STACK_LIMIT = 16


def _stack() -> str:
    return "".join(traceback.format_stack(limit=_STACK_LIMIT)[:-2])


class Checker:
    """Per-thread held-lock accounting.  ``mode`` "raise" raises at the
    acquire site; "warn" appends to ``violations`` (one entry per
    message and code location) and carries on."""

    def __init__(self, mode: str = "raise"):
        if mode not in ("raise", "warn"):
            raise ValueError("mode must be 'raise' or 'warn'")
        self.mode = mode
        self.violations: list[str] = []
        self._seen: set[tuple] = set()
        self._tls = threading.local()

    def _held(self) -> list:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def held_names(self) -> list[str]:
        return [e[0].name for e in self._held()]

    def before_acquire(self, lock, blocking: bool) -> None:
        """The rank check, before the raw acquire.  A non-blocking
        attempt cannot wait, so it skips the check."""
        held = self._held()
        if not held:
            return
        if any(entry[0] is lock for entry in held):
            self._violate("self-deadlock: thread re-acquiring lock "
                          f"'{lock.name}' it already holds")
            return
        if not blocking:
            return
        top = max(held, key=lambda e: e[0].rank)[0]
        if lock.rank > top.rank:
            return
        if lock.rank == top.rank and lock.multi and lock.name == top.name:
            return  # peer instances of a multi lock
        self._violate(f"rank inversion: acquiring '{lock.name}' "
                      f"(rank {lock.rank}) while holding '{top.name}' "
                      f"(rank {top.rank}); declared order requires "
                      f"'{lock.name}' first.  held={self.held_names()}")

    def after_acquire(self, lock) -> None:
        self._held().append([lock, 1])

    def on_release(self, lock) -> None:
        held = self._held()
        for i, entry in enumerate(held):
            if entry[0] is lock:
                del held[i]
                return

    def _violate(self, msg: str) -> None:
        if self.mode == "raise":
            raise LockRankError(msg + "\n--- acquiring stack ---\n"
                                + _stack())
        site = traceback.extract_stack(limit=8)
        loc = next((f"{f.filename}:{f.lineno}" for f in reversed(site)
                    if "lockrank" not in f.filename), "?")
        key = (msg, loc)
        if key not in self._seen:
            self._seen.add(key)
            self.violations.append(f"{msg} at {loc}")


_checker: Checker | None = None


def enable(mode: str = "raise") -> Checker:
    global _checker
    _checker = Checker(mode)
    return _checker


def disable() -> None:
    global _checker
    _checker = None


def violations() -> list[str]:
    c = _checker
    return list(c.violations) if c is not None else []


class RankedLock:
    """threading.Lock with a declared rank.  A name missing from
    LOCK_RANKS raises at construction."""

    __slots__ = ("name", "rank", "multi", "_lock")

    def __init__(self, name: str):
        rank = LOCK_RANKS.get(name)
        if rank is None:
            raise ValueError(
                f"lock name {name!r} is not in lockrank.LOCK_RANKS")
        self.name = name
        self.rank = rank
        self.multi = name in MULTI_OK
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        c = _checker
        if c is None:
            return self._lock.acquire(blocking, timeout)
        c.before_acquire(self, blocking)
        got = self._lock.acquire(blocking, timeout)
        if got:
            c.after_acquire(self)
        return got

    def release(self) -> None:
        self._lock.release()
        c = _checker
        if c is not None:
            c.on_release(self)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False
