"""Trust-path planner (the port's copy of `cometbft_tpu.lightserve.
planner`): precompute the skipping-bisection paths common client trust
heights walk, and keep their encoded payloads hot.

A skipping light client (light/client.py _verify_skipping) that cannot
trust the target directly pivots at 9/16 of the remaining span and
retries; under a stable validator-set overlap profile the heights it
will request are a deterministic function of (trusted, target).  The
serving node exploits that: ``skip_path`` reproduces the pivot chain,
the planner counts which trust heights clients actually arrive with,
and ``prefetch`` encodes the union of the hot paths' LightBlock
payloads into a SerializedBlockCache so the serve path hands out cached
wire bytes without re-joining header + commit + valset per request.
"""

from __future__ import annotations

from collections import Counter

from ..libs import lockrank
from ..types.part_set import SerializedBlockCache

# pivot ratio, identical to light/client.py (client.go:31-32) so the
# server-side plan is the path a real skipping client would walk
_SKIP_NUM = 9
_SKIP_DEN = 16

# the JAX package's defaults; pass other values to the constructor
DEFAULT_PLAN_DEPTH = 64
DEFAULT_PAYLOAD_CAPACITY = 1024


def skip_path(trusted: int, target: int,
              max_pivots: int = DEFAULT_PLAN_DEPTH) -> list[int]:
    """Heights a skipping client verifies between ``trusted``
    (exclusive) and ``target`` (inclusive): the geometric 9/16 pivot
    chain, worst case for trust propagation (every direct try fails,
    every pivot verifies).  ``max_pivots`` bounds pathological spans."""
    if target <= trusted:
        return []
    path: list[int] = []
    v = trusted
    while len(path) < max_pivots:
        span = target - v
        if span <= 1:
            break
        p = v + span * _SKIP_NUM // _SKIP_DEN
        if p <= v:
            p = v + 1
        if p >= target:
            break
        path.append(p)
        v = p
    path.append(target)
    return path


class TrustPathPlanner:
    """Hot-path profile + payload cache for one serving session.

    The lock guards only the trust-height counter; the payload cache
    (part_set.block_cache, rank far below lightserve.planner) has its
    own lock and is never touched while the planner lock is held."""

    def __init__(self, max_pivots: int | None = None,
                 payload_capacity: int | None = None):
        self.max_pivots = (DEFAULT_PLAN_DEPTH if max_pivots is None
                           else max(1, int(max_pivots)))
        self.cache = SerializedBlockCache(
            capacity=DEFAULT_PAYLOAD_CAPACITY
            if payload_capacity is None else payload_capacity)
        self._mtx = lockrank.RankedLock("lightserve.planner")
        self._trust_counts: Counter = Counter()
        self.plans = 0
        self.prefetched = 0

    def plan(self, trusted: int, target: int) -> list[int]:
        """The serve path for one request; notes the trust height in
        the hot profile as a side effect."""
        with self._mtx:
            self._trust_counts[trusted] += 1
            self.plans += 1
        return skip_path(trusted, target, self.max_pivots)

    def hot_trust_heights(self, top_n: int = 8) -> list[int]:
        with self._mtx:
            return [h for h, _ in self._trust_counts.most_common(top_n)]

    def hot_heights(self, target: int, top_n: int = 8) -> list[int]:
        """Union of the skip paths the most common trust heights walk
        to ``target``: the prefetch frontier."""
        out: set[int] = set()
        for trusted in self.hot_trust_heights(top_n):
            out.update(skip_path(trusted, target, self.max_pivots))
        return sorted(out)

    def prefetch(self, target: int, encode_fn, top_n: int = 8) -> int:
        """Encode not-yet-cached payloads on the hot paths;
        ``encode_fn(height) -> bytes | None`` joins and serializes one
        LightBlock.  Returns how many payloads were newly encoded."""
        fresh = 0
        for h in self.hot_heights(target, top_n):
            if self.cache.get_block_bytes(h) is not None:
                continue
            blob = encode_fn(h)
            if blob is None:
                continue
            self.cache.put(h, blob, ())
            fresh += 1
        if fresh:
            with self._mtx:
                self.prefetched += fresh
        return fresh

    def payload(self, height: int) -> bytes | None:
        return self.cache.get_block_bytes(height)

    def put_payload(self, height: int, blob: bytes) -> None:
        self.cache.put(height, blob, ())

    def stats(self) -> dict:
        with self._mtx:
            distinct = len(self._trust_counts)
            plans = self.plans
            prefetched = self.prefetched
        return {
            "plans": plans,
            "distinct_trust_heights": distinct,
            "prefetched": prefetched,
            "payload_cache_hits": self.cache.hits,
            "payload_cache_misses": self.cache.misses,
            "payload_cache_evictions": self.cache.evictions,
            "payload_cache_entries": len(self.cache),
        }
