"""Flow-rate monitoring and limiting (the port's copy of
`cometbft_tpu.libs.flowrate`; CometBFT internal/flowrate/).

Token-bucket style: a Monitor tracks transfer rate over a sliding
window; Limit() tells the caller how many bytes it may move now to stay
under a target rate, used by MConnection's send/recv routines.
"""

from __future__ import annotations

import time

from . import lockrank


class Monitor:
    """flowrate.Monitor: EMA transfer-rate sampling."""

    def __init__(self, sample_period: float = 0.1,
                 window: float = 1.0):
        self._mtx = lockrank.RankedLock("flowrate")
        self._sample_period = sample_period
        self._window = window
        self._start = time.monotonic()
        self._bytes = 0            # total transferred
        self._rate_ema = 0.0       # bytes/sec
        self._sample_bytes = 0
        self._sample_start = self._start
        self._active = True
        # token bucket for limit(): refilled at the caller's rate,
        # burst-capped to one window
        self._tokens = 0.0
        self._bucket_rate = 0
        self._last_refill = self._start

    def update(self, n: int) -> int:
        """Record n transferred bytes; returns n."""
        with self._mtx:
            now = time.monotonic()
            self._bytes += n
            self._sample_bytes += n
            self._tokens = max(self._tokens - n, 0.0)
            elapsed = now - self._sample_start
            if elapsed >= self._sample_period:
                rate = self._sample_bytes / elapsed
                w = min(elapsed / self._window, 1.0)
                self._rate_ema = self._rate_ema * (1 - w) + rate * w
                self._sample_bytes = 0
                self._sample_start = now
        return n

    def status(self) -> dict:
        with self._mtx:
            now = time.monotonic()
            duration = now - self._start
            avg = self._bytes / duration if duration > 0 else 0.0
            return {
                "bytes": self._bytes,
                "duration": duration,
                "avg_rate": avg,
                "cur_rate": self._rate_ema,
            }

    def limit(self, want: int, rate: int, block: bool = False) -> int:
        """How many of `want` bytes may be transferred now to keep the
        rate <= rate bytes/sec (0 = unlimited). Token bucket with burst
        capped to one window — idle time does NOT accrue unbounded
        credit. Callers report actual transfer via update(), which
        drains the bucket. If block, sleep until at least one byte is
        allowed (flowrate Limit)."""
        if rate <= 0:
            return want
        while True:
            with self._mtx:
                now = time.monotonic()
                if self._bucket_rate != rate:
                    # rate changed (or first use): start with one window
                    self._bucket_rate = rate
                    self._tokens = float(rate) * self._window
                    self._last_refill = now
                self._tokens = min(
                    self._tokens + rate * (now - self._last_refill),
                    float(rate) * self._window)
                self._last_refill = now
                allowed = int(min(want, self._tokens))
            if allowed > 0:
                return allowed
            if not block:
                return 0
            time.sleep(max(1.0 / rate, 0.001))
