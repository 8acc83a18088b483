"""Lock ranks and the concurrency sanitizer seams: the port's copy of
`cometbft_tpu.libs.lockrank`, over the locks the port has.

- ``RankedLock`` / ``RankedRLock`` / ``RankedCondition`` wrap the raw
  ``threading`` primitives with a declared rank;
- ``LOCK_RANKS`` holds one rank per named lock (the JAX package's
  numbers): lower rank = acquired FIRST (outermost).  With a checker
  installed (``enable``), acquiring a lock whose rank is <= the highest
  rank the thread already holds is a rank inversion: it raises
  ``LockRankError`` BEFORE the acquire blocks ("raise" mode), or is
  recorded in ``violations()`` and the thread carries on ("warn" mode);
- a cross-thread edge table: the first time a thread acquires B while
  holding A, the edge A -> B is kept with its stack, and a later
  inversion's report carries both stacks;
- the thread- and future-leak registries: ``TrackedFuture`` is the
  Future the verify pipeline (crypto/dispatch.py) mints its window
  futures from; one garbage-collected with an exception nobody
  retrieved is a swallowed failure, listed by ``leaked_futures()``.

With no checker the cost is one module-global read and a branch ahead
of the raw lock.  A lock whose name is in ``MULTI_OK`` has many peer
instances under one name: peers may nest at equal rank, and same-name
pairs stay out of the edge table.  A name missing from LOCK_RANKS
raises at construction.
"""

from __future__ import annotations

import os
import threading
import traceback
import weakref
from concurrent.futures import Future

# lower rank = acquired first; the JAX package's ranks for the same names
LOCK_RANKS: dict[str, int] = {
    # the light-client fleet driver (simnet/lightfleet.py): its tallies
    # only, never held across a serve call
    "simnet.lightfleet": 11,
    # the light-client serving plane (lightserve/): held only around
    # queue and counter changes, never across store reads or pipeline
    # submits, but the request path reaches the stores, the payload
    # cache and the verify plane after release, so it ranks outside them
    "lightserve.session": 12,
    "lightserve.cv": 14,
    "lightserve.planner": 16,
    # consensus core: the state mutex is the outermost product lock;
    # nearly every subsystem below is reachable while it is held
    "consensus.state": 20,
    "consensus.peerstate": 30,
    "consensus.ticker": 40,
    "evidence.pool": 50,
    # per-request ABCI callback guard: fires mempool callbacks while held,
    # so it sits outside the mempool mutex
    "abci.reqres": 55,
    "mempool.clist": 60,
    "mempool.cache": 70,
    "blocksync.pool": 80,
    # storage plane (held while touching kv and the encode-once cache)
    "store.blockstore": 140,
    "state.store": 150,
    "store.kv": 160,
    "pubsub": 170,
    # p2p edge: the switch's dial set, the peer set and each peer's
    # data, then a SecretConnection's send and receive halves
    "p2p.switch": 180,
    "p2p.peer": 210,
    "p2p.peer_data": 220,
    "p2p.conn.send": 250,
    "p2p.conn.recv": 260,
    # abci / app
    "abci.client": 290,
    "apps.kvstore": 330,
    # verify plane: the default-instance guards, the vote stream's
    # condition variable (its worker polls the pipeline's QoS seal
    # advisory under it), then the pipeline's condition variable
    # (submitters, staging, dispatch loops and the watchdog share it),
    # then what the pipeline consults under it
    "dispatch.default": 370,
    "votestream.default": 380,
    "votestream.cv": 390,
    "dispatch.cv": 400,
    # the WAL's rotating file group: taken alone, around a file write
    "autofile": 410,
    "devhealth.registry": 420,
    "ed25519.atable": 430,
    "secp256k1.qtable": 440,
    "sigcache.global": 450,
    "sigcache.stripe": 460,
    "part_set.block_cache": 470,
    "flowrate": 480,
    # observability rings: leaf-most, recordable from under any of the
    # above.  latledger sits outside flightrec: committing a row under
    # its ring lock may record an EV_SLO_BURN event
    "devprof.ring": 490,
    "latledger.ring": 495,
    "flightrec.ring": 500,
    "tracetl.ring": 510,
    "trace.stage": 520,
    "metrics.registry": 530,
    "metrics.series": 540,
    "service.lifecycle": 550,
    # the bls12381 library handle: taken alone, around its build and load
    "bls12381.lib": 570,
}

MULTI_OK = frozenset({
    "lightserve.session", "lightserve.cv", "lightserve.planner",
    "p2p.switch", "p2p.peer", "p2p.peer_data", "p2p.conn.send",
    "p2p.conn.recv", "flowrate",
    "consensus.state", "consensus.peerstate", "consensus.ticker",
    "evidence.pool", "mempool.clist", "mempool.cache", "pubsub", "autofile",
    "blocksync.pool", "store.blockstore", "state.store", "store.kv",
    "abci.client", "apps.kvstore", "abci.reqres", "part_set.block_cache",
    "votestream.cv", "dispatch.cv", "devhealth.registry", "sigcache.stripe",
    "devprof.ring", "flightrec.ring", "tracetl.ring", "trace.stage",
    "metrics.registry", "metrics.series", "service.lifecycle",
})


class LockRankError(RuntimeError):
    """A rank inversion or cross-thread acquisition cycle, raised
    before the offending acquire blocks, with the locks the thread
    holds (and the other thread's recorded stack when the reverse edge
    is known)."""


_STACK_LIMIT = 16


def _stack() -> str:
    return "".join(traceback.format_stack(limit=_STACK_LIMIT)[:-2])


class Checker:
    """Per-thread held-lock accounting + the cross-thread edge table.

    One instance is installed process-wide (``enable``); every
    Ranked* op funnels through it when installed.  ``mode``:

    - "raise": violations raise LockRankError at the acquire site;
    - "warn":  violations append to ``violations`` (deduplicated by
      lock pair + code location) and execution continues — the
      bring-up mode that maps real acquisition order in one run.
    """

    def __init__(self, mode: str = "raise"):
        if mode not in ("raise", "warn"):
            raise ValueError("mode must be 'raise' or 'warn'")
        self.mode = mode
        self.violations: list[str] = []
        self._seen: set[tuple] = set()
        self._tls = threading.local()
        # (held_name, acquired_name) -> formatted stack of first sight.
        # Guarded by a RAW lock: the checker cannot check itself.
        self._edges: dict[tuple[str, str], str] = {}
        self._emtx = threading.Lock()

    # -- held-lock bookkeeping (all called from the owning thread) -----

    def _held(self) -> list:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def held_names(self) -> list[str]:
        return [e[0].name for e in self._held()]

    def before_acquire(self, lock, blocking: bool) -> None:
        """Rank + cycle check, BEFORE the raw acquire (so a would-be
        deadlock reports instead of deadlocking).  Non-blocking
        attempts skip the rank check (a trylock cannot wait, hence
        cannot deadlock at this site) but their success still lands in
        the held list via after_acquire."""
        held = self._held()
        if not held:
            return
        for entry in held:
            if entry[0] is lock:
                if lock.reentrant:
                    return
                self._violate(
                    "self-deadlock: thread re-acquiring non-reentrant "
                    f"lock '{lock.name}' it already holds", lock)
                return
        if not blocking:
            return
        top = max(held, key=lambda e: e[0].rank)[0]
        if lock.rank > top.rank:
            self._note_edges(held, lock)
            return
        if (lock.rank == top.rank and lock.multi
                and lock.name == top.name):
            return  # peer instances of a multi lock
        other = self._edges.get((lock.name, top.name))
        msg = (f"rank inversion: acquiring '{lock.name}' "
               f"(rank {lock.rank}) while holding '{top.name}' "
               f"(rank {top.rank}); declared order requires "
               f"'{lock.name}' first.  held={self.held_names()}")
        if other is not None:
            msg += ("\n--- stack that established the opposite order "
                    f"('{lock.name}' -> '{top.name}') ---\n" + other)
        self._violate(msg, lock)

    def _note_edges(self, held, lock) -> None:
        for entry in held:
            a = entry[0]
            if a.name == lock.name:
                continue
            key = (a.name, lock.name)
            if key in self._edges:
                continue
            st = _stack()
            with self._emtx:
                self._edges.setdefault(key, st)

    def after_acquire(self, lock) -> None:
        held = self._held()
        for entry in held:
            if entry[0] is lock:
                entry[1] += 1
                return
        held.append([lock, 1])

    def on_release(self, lock) -> None:
        held = self._held()
        for i, entry in enumerate(held):
            if entry[0] is lock:
                entry[1] -= 1
                if entry[1] <= 0:
                    del held[i]
                return

    # condition-variable wait: the cv's lock leaves the held set for
    # the duration (wait releases it), everything ELSE the thread holds
    # stays — and holding anything else across a wait is itself a
    # blocking-under-lock hazard worth reporting
    def on_wait_release(self, lock):
        held = self._held()
        others = [e[0].name for e in held if e[0] is not lock]
        if others:
            self._violate(
                f"cv wait on '{lock.name}' while holding {others}: "
                "a condition wait must not park other held locks",
                lock)
        for i, entry in enumerate(held):
            if entry[0] is lock:
                del held[i]
                return entry
        return None

    def on_wait_reacquire(self, lock, token) -> None:
        if token is not None:
            self._held().append(token)

    # -- violation sink ------------------------------------------------

    def _violate(self, msg: str, lock) -> None:
        if self.mode == "raise":
            raise LockRankError(msg + "\n--- acquiring stack ---\n"
                                + _stack())
        site = traceback.extract_stack(limit=8)
        loc = next((f"{f.filename}:{f.lineno}"
                    for f in reversed(site)
                    if "lockrank" not in f.filename), "?")
        key = (msg.split("\n", 1)[0], loc)
        if key not in self._seen:
            self._seen.add(key)
            self.violations.append(f"{msg.splitlines()[0]} at {loc}")


# -- process-wide checker seam (flightrec discipline) -----------------------

_checker: Checker | None = None


def enable(mode: str = "raise") -> Checker:
    global _checker
    _checker = Checker(mode)
    return _checker


def disable() -> None:
    global _checker
    _checker = None


def checker() -> Checker | None:
    return _checker


def enabled() -> bool:
    return _checker is not None


def violations() -> list[str]:
    c = _checker
    return list(c.violations) if c is not None else []


def enable_from_env() -> Checker | None:
    """Install a checker according to COMETBFT_TPU_LOCKRANK: "1"/
    "raise" -> raise mode, "warn" -> warn mode, anything else -> off.
    A test run calls this once."""
    v = os.environ.get("COMETBFT_TPU_LOCKRANK", "0")
    if v in ("1", "raise"):
        return enable("raise")
    if v == "warn":
        return enable("warn")
    disable()
    return None


# ---------------------------------------------------------------------------
# The ranked lock family
# ---------------------------------------------------------------------------


class RankedLock:
    """threading.Lock with a declared rank.  Disabled-checker cost:
    one global read + one branch per op, then the raw C lock."""

    reentrant = False
    __slots__ = ("name", "rank", "multi", "_lock")

    def __init__(self, name: str):
        rank = LOCK_RANKS.get(name)
        if rank is None:
            raise ValueError(
                f"lock name {name!r} is not in lockrank.LOCK_RANKS — "
                "add it to the table")
        self.name = name
        self.rank = rank
        self.multi = name in MULTI_OK
        self._lock = self._make_lock()

    def _make_lock(self):
        return threading.Lock()

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
        c = _checker
        if c is None:
            self._lock.acquire()
            return self
        c.before_acquire(self, True)
        self._lock.acquire()
        c.after_acquire(self)
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"<{type(self).__name__} {self.name!r} "
                f"rank={self.rank}>")


class RankedRLock(RankedLock):
    """threading.RLock with a declared rank (reentrant: re-acquiring
    the SAME instance never violates)."""

    reentrant = True
    __slots__ = ()

    def _make_lock(self):
        return threading.RLock()

    def locked(self):  # pragma: no cover - parity with RLock
        raise AttributeError("RLock has no locked()")

    # threading.Condition(raw) support
    def _is_owned(self) -> bool:
        return self._lock._is_owned()


class RankedCondition:
    """threading.Condition over a ranked lock.

    Construct with a name (fresh RankedRLock underneath, matching
    threading.Condition()'s default RLock) or with an existing
    RankedLock/RankedRLock (the ``Condition(self._mtx)`` sharing
    pattern).  wait/wait_for temporarily drop the cv's lock from the
    checker's held set — and report if the thread parks while holding
    any OTHER ranked lock."""

    __slots__ = ("_rlock", "_cond")

    def __init__(self, lock: RankedLock | None = None,
                 name: str | None = None):
        if lock is None:
            if name is None:
                raise ValueError("RankedCondition needs a lock or name")
            lock = RankedRLock(name)
        elif not isinstance(lock, RankedLock):
            raise TypeError("RankedCondition requires a ranked lock")
        self._rlock = lock
        self._cond = threading.Condition(lock._lock)

    @property
    def name(self) -> str:
        return self._rlock.name

    @property
    def rank(self) -> int:
        return self._rlock.rank

    def acquire(self, *a, **kw):
        return self._rlock.acquire(*a, **kw)

    def release(self) -> None:
        self._rlock.release()

    def __enter__(self):
        self._rlock.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._rlock.release()
        return False

    def wait(self, timeout: float | None = None) -> bool:
        c = _checker
        if c is None:
            return self._cond.wait(timeout)
        token = c.on_wait_release(self._rlock)
        try:
            return self._cond.wait(timeout)
        finally:
            c2 = _checker
            if c2 is not None:
                c2.on_wait_reacquire(self._rlock, token)

    def wait_for(self, predicate, timeout: float | None = None):
        c = _checker
        if c is None:
            return self._cond.wait_for(predicate, timeout)
        token = c.on_wait_release(self._rlock)
        try:
            return self._cond.wait_for(predicate, timeout)
        finally:
            c2 = _checker
            if c2 is not None:
                c2.on_wait_reacquire(self._rlock, token)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()


# ---------------------------------------------------------------------------
# Future-leak seam (sanitizer): crypto/dispatch.py mints its window
# futures from TrackedFuture; a future collected with an exception
# nobody retrieved is a swallowed failure the tests must see.
# ---------------------------------------------------------------------------

_san_enabled = False
_leaked_futures: list[str] = []
_pending_exc: "weakref.WeakSet[TrackedFuture]" = weakref.WeakSet()


def sanitizer_enabled() -> bool:
    return _san_enabled


def set_sanitizer(on: bool) -> None:
    """Arm/disarm the future-leak registry (a test run does)."""
    global _san_enabled
    _san_enabled = bool(on)


def leaked_futures() -> list[str]:
    """Descriptions of futures garbage-collected with an unretrieved
    exception since the last clear."""
    return list(_leaked_futures)


def clear_leaked_futures() -> None:
    del _leaked_futures[:]
    # drop pending markers too: a cleared slate must not blame earlier
    # tests' still-live futures on the next test
    for f in list(_pending_exc):
        f._lr_retrieved = True
    _pending_exc.clear()


class TrackedFuture(Future):
    """concurrent.futures.Future that reports exception-drop leaks.

    set_exception marks the future pending-retrieval; result()/
    exception() clear the mark; __del__ on a still-marked future
    records the leak (the sys.unraisablehook conftest wrapper catches
    anything this finalizer itself cannot say)."""

    def __init__(self):
        super().__init__()
        self._lr_retrieved = False
        self._lr_where: str | None = None

    def set_exception(self, exception) -> None:
        if _san_enabled:
            self._lr_where = _stack()
            _pending_exc.add(self)
        super().set_exception(exception)

    def _lr_mark(self):
        self._lr_retrieved = True

    def result(self, timeout=None):
        self._lr_retrieved = True
        return super().result(timeout)

    def exception(self, timeout=None):
        self._lr_retrieved = True
        return super().exception(timeout)

    def __del__(self):
        if not _san_enabled or self._lr_retrieved:
            return
        try:
            exc = super().exception(timeout=0)
        except Exception:
            return
        if exc is None:
            return
        where = self._lr_where or "(set_exception stack not captured)"
        _leaked_futures.append(
            "future dropped with unretrieved exception "
            f"{type(exc).__name__}: {exc!r}\n"
            "--- set_exception stack ---\n" + where)


# ---------------------------------------------------------------------------
# Thread-leak helper backing the conftest fixture
# ---------------------------------------------------------------------------


def sanctioned_threads() -> set:
    """Threads owned by the process-wide default engines (dispatch
    default pipeline, votestream default verifier): long-lived BY
    DESIGN, not leaks.  Resolved lazily so merely importing lockrank
    never constructs them."""
    import sys

    out: set = set()
    disp = sys.modules.get("cometbft_tpu_torch.crypto.dispatch")
    vs = sys.modules.get("cometbft_tpu_torch.crypto.votestream")
    for mod in (disp, vs):
        d = getattr(mod, "_default", None) if mod is not None else None
        if d is None:
            continue
        for attr in ("_staging", "_device", "_watchdog", "_thread"):
            th = getattr(d, attr, None)
            if th is not None:
                out.add(th)
        out.update(getattr(d, "_dev_threads", ()) or ())
        pool = getattr(d, "_pool", None)
        if pool is not None:
            out.update(getattr(pool, "_threads", ()) or ())
    return out


def leaked_threads(baseline: set, grace_s: float = 1.0) -> list:
    """Non-daemon threads alive now that were not in ``baseline`` and
    are not sanctioned default-engine threads; each gets up to
    ``grace_s`` (total) to finish before being reported."""
    import time

    deadline = time.monotonic() + grace_s
    leaked = []
    for th in threading.enumerate():
        if th in baseline or th.daemon or not th.is_alive():
            continue
        if th is threading.current_thread():
            continue
        th.join(timeout=max(0.0, deadline - time.monotonic()))
        if th.is_alive():
            leaked.append(th)
    return [t for t in leaked if t not in sanctioned_threads()]
