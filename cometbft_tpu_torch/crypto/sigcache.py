"""Process-wide signature-verdict cache — the port's counterpart of
`cometbft_tpu.crypto.sigcache`: first-seen verify, re-verify for one
SHA-256.

Commit verification re-checks signatures the process already proved:
at height H+1 a node re-verifies H's LastCommit, and a light client or
blocksync window re-sends triples it has seen.  A signature verdict is
an immutable fact of its inputs, so it is content-addressed once and
every later consumer gets the answer for a SHA-256 instead of a device
program.

- One SHA-256 over the length-framed (key_type, pubkey, msg, sig) is
  the key; the verdict is a bool.  The key equals the JAX package's
  for the same triple.  The FULL triple is hashed, so positive and
  negative verdicts are both cacheable and cannot be poisoned: a cached
  False is the verdict of that exact triple.
- A lock-striped bounded LRU: 16 stripes, each its own ranked lock and
  OrderedDict.
- Performance only, never behavior: consumers (types/validation,
  crypto/batch.safe_verify) partition into hits and misses and verify
  only the misses, with the same verdicts and the same errors as with
  the cache off.  The batch verifiers insert every verdict they compute
  (crypto/batch._SigCollector.verify).
- On by default; COMETBFT_TPU_SIGCACHE=0 turns it off, read on every
  call, and set_enabled(True / False) overrides the variable until
  set_enabled(None).  Off, every helper returns at once.

Instrumented as in the JAX package: CacheMetrics (libs/metrics.py,
per-consumer labels through the `consumer(...)` context manager) and the
flight recorder's EV_CACHE_LOOKUP / EV_CACHE_INSERT events on batch
seams, beside the cache's own counters (SigVerdictCache.stats).
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict

from ..libs import lockrank

DEFAULT_CAPACITY = int(os.environ.get(
    "COMETBFT_TPU_SIGCACHE_CAPACITY", "131072"))
STRIPES = 16

# consumers: the product path that asked; "crypto" is the default, a
# lookup below any labelled seam
_tls = threading.local()

# the closed consumer registry of the JAX package
CONSUMERS = frozenset({
    "consensus", "blocksync", "light", "lightserve", "evidence",
    "crypto", "bench", "probe",
})

# QoS lane priorities over the consumer registry (lower = more urgent),
# as the JAX package declares them for its verify pipeline's scheduler
LANES = {
    "consensus": 0,
    "probe": 0,
    "evidence": 1,
    "light": 2,
    "lightserve": 2,
    "blocksync": 3,
    "crypto": 4,
    "bench": 4,
}
# labels outside CONSUMERS schedule at the lowest priority class
DEFAULT_LANE_PRIORITY = 4


def lane_priority(label: str) -> int:
    """Dispatch priority class for a consumer label (lower = more
    urgent); unregistered labels fall into the default class."""
    return LANES.get(label, DEFAULT_LANE_PRIORITY)


class consumer:
    """Context manager labelling cache traffic with the product path
    (consensus / blocksync / light / ...).  Thread-local and reentrant
    (inner labels win)."""

    __slots__ = ("label", "_prev")

    def __init__(self, label: str):
        self.label = label
        self._prev = None

    def __enter__(self) -> "consumer":
        self._prev = getattr(_tls, "label", None)
        _tls.label = self.label
        return self

    def __exit__(self, *exc) -> bool:
        _tls.label = self._prev
        return False


def current_consumer() -> str:
    return getattr(_tls, "label", None) or "crypto"


def _pk_bytes(pk) -> bytes:
    return pk.bytes() if hasattr(pk, "bytes") else bytes(pk)


def _pk_type(pk) -> str:
    return pk.type() if hasattr(pk, "type") else "ed25519"


def key(pubkey, msg: bytes, sig: bytes,
        key_type: str | None = None) -> bytes:
    """Content address of one (pubkey, msg, sig) triple: one SHA-256
    over the length-framed concatenation (the framing prevents
    boundary-shift collisions; the key type is part of it because the
    same raw key bytes mean different curves under different types).
    Accepts a key object or raw bytes (ed25519 unless key_type says
    otherwise)."""
    if key_type is None:
        key_type = _pk_type(pubkey)
    pk = _pk_bytes(pubkey)
    h = hashlib.sha256()
    h.update(key_type.encode())
    h.update(len(pk).to_bytes(4, "little"))
    h.update(pk)
    h.update(len(msg).to_bytes(4, "little"))
    h.update(msg)
    h.update(sig)
    return h.digest()


class SigVerdictCache:
    """Lock-striped bounded LRU mapping key() digests to bool verdicts,
    with its counters (hits, negative_hits, misses, insertions,
    evictions)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 stripes: int = STRIPES):
        self.capacity = max(int(capacity), stripes)
        self.stripes = stripes
        # ceil-divide so stripes * per_stripe >= capacity
        self._per_stripe = -(-self.capacity // stripes)
        self._locks = [lockrank.RankedLock("sigcache.stripe")
                       for _ in range(stripes)]
        self._maps: list[OrderedDict] = [
            OrderedDict() for _ in range(stripes)]
        self.hits = 0
        self.negative_hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0

    def _stripe(self, k: bytes) -> int:
        # the key is a SHA-256 digest: any byte is uniform
        return k[0] % self.stripes

    def lookup(self, k: bytes) -> bool | None:
        """Verdict for a key() digest, None on a miss.  A hit refreshes
        its recency.  The module-level helpers keep the counters, so a
        batch seam counts once per batch."""
        i = self._stripe(k)
        with self._locks[i]:
            m = self._maps[i]
            v = m.get(k)
            if v is None:
                return None
            m.move_to_end(k)
            return v

    def store(self, k: bytes, verdict: bool) -> int:
        """Insert one verdict; returns the evictions made (0 or 1).
        Re-inserting a key refreshes its recency."""
        i = self._stripe(k)
        with self._locks[i]:
            m = self._maps[i]
            if k in m:
                m.move_to_end(k)
                m[k] = bool(verdict)
                return 0
            m[k] = bool(verdict)
            if len(m) > self._per_stripe:
                m.popitem(last=False)
                return 1
            return 0

    def __len__(self) -> int:
        return sum(len(m) for m in self._maps)

    def clear(self) -> None:
        for i in range(self.stripes):
            with self._locks[i]:
                self._maps[i].clear()

    def stats(self) -> dict:
        looked = self.hits + self.misses
        return {
            "entries": len(self),
            "capacity": self.capacity,
            "hits": self.hits,
            "negative_hits": self.negative_hits,
            "misses": self.misses,
            "insertions": self.insertions,
            "evictions": self.evictions,
            "hit_rate": round(self.hits / looked, 4) if looked else 0.0,
        }


# -- process-wide default instance -------------------------------------------

_cache: SigVerdictCache | None = None
_cache_lock = lockrank.RankedLock("sigcache.global")
# tri-state override: None defers to COMETBFT_TPU_SIGCACHE (default on)
_enabled_override: bool | None = None


def cache() -> SigVerdictCache:
    global _cache
    with _cache_lock:
        if _cache is None:
            _cache = SigVerdictCache()
        return _cache


def reset(capacity: int | None = None) -> SigVerdictCache:
    """A fresh process-wide cache; returns it."""
    global _cache
    with _cache_lock:
        _cache = SigVerdictCache(
            capacity if capacity is not None else DEFAULT_CAPACITY)
        return _cache


def enabled() -> bool:
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get("COMETBFT_TPU_SIGCACHE", "1") != "0"


def set_enabled(v: bool | None) -> None:
    global _enabled_override
    _enabled_override = v


def _metrics():
    from ..libs import metrics as libmetrics

    return libmetrics.cache_metrics()


def _account(label: str, hits: int, negs: int, misses: int) -> None:
    c = cache()
    c.hits += hits
    c.negative_hits += negs
    c.misses += misses
    cm = _metrics()
    if cm is not None:
        if hits:
            cm.hits.labels(label).inc(hits)
        if negs:
            cm.negative_hits.labels(label).inc(negs)
        if misses:
            cm.misses.labels(label).inc(misses)


def get(pubkey, msg: bytes, sig: bytes,
        key_type: str | None = None,
        label: str | None = None) -> bool | None:
    """Single-triple lookup: the verdict, or None (a miss, or the cache
    off).  `label` names the consumer's metrics series (default: the
    current consumer)."""
    if not enabled():
        return None
    v = cache().lookup(key(pubkey, msg, sig, key_type))
    if label is None:
        label = current_consumer()
    if v is None:
        _account(label, 0, 0, 1)
    else:
        _account(label, 1, 0 if v else 1, 0)
    return v


def insert(pubkey, msg: bytes, sig: bytes, verdict: bool,
           key_type: str | None = None,
           label: str | None = None) -> None:
    if not enabled():
        return
    c = cache()
    ev = c.store(key(pubkey, msg, sig, key_type), verdict)
    c.insertions += 1
    c.evictions += ev
    cm = _metrics()
    if cm is not None:
        cm.insertions.labels(label or current_consumer()).inc()
        if ev:
            cm.evictions.inc(ev)
        cm.entries.set(len(c))


def partition(items, label: str | None = None,
              count_misses: bool = True):
    """Batch consult: `items` is a sequence of (pubkey, msg, sig) (key
    objects or raw bytes).  Returns (verdicts, miss_idx): one bool or
    None (a miss: verify it) per item, and the positions to verify.
    With the cache off everything is a miss and nothing is hashed.
    count_misses=False leaves the misses uncounted, for a seam that
    re-consults triples already counted."""
    items = list(items)
    if not enabled() or not items:
        return [None] * len(items), list(range(len(items)))
    c = cache()
    verdicts: list[bool | None] = []
    miss_idx: list[int] = []
    hits = negs = 0
    for i, (pk, msg, sig) in enumerate(items):
        v = c.lookup(key(pk, msg, sig))
        verdicts.append(v)
        if v is None:
            miss_idx.append(i)
        else:
            hits += 1
            if not v:
                negs += 1
    if label is None:
        label = current_consumer()
    _account(label, hits, negs, len(miss_idx) if count_misses else 0)
    if hits and len(items) >= 2:
        from ..libs import flightrec

        flightrec.record(flightrec.EV_CACHE_LOOKUP, consumer=label,
                         batch=len(items), hits=hits, negative=negs,
                         misses=len(miss_idx))
    return verdicts, miss_idx


def insert_many(items, verdicts, label: str | None = None,
                key_type: str | None = None) -> None:
    """Batch populate: one (pubkey, msg, sig) and bool verdict a slot.
    key_type overrides the per-item inference where the items carry raw
    key bytes of a known type (the typed batch verifiers)."""
    if not enabled() or not items:
        return
    c = cache()
    ev = n = 0
    for (pk, msg, sig), v in zip(items, verdicts):
        ev += c.store(key(pk, msg, sig, key_type), bool(v))
        n += 1
    c.insertions += n
    c.evictions += ev
    if label is None:
        label = current_consumer()
    cm = _metrics()
    if cm is not None:
        cm.insertions.labels(label).inc(n)
        if ev:
            cm.evictions.inc(ev)
        cm.entries.set(len(c))
    if n >= 2:
        from ..libs import flightrec

        flightrec.record(flightrec.EV_CACHE_INSERT, consumer=label,
                         count=n, evicted=ev)
