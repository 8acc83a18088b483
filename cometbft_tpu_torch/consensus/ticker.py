"""TimeoutTicker: the single scheduled-timeout abstraction driving
round progression (the port's copy of `cometbft_tpu.consensus.ticker`;
CometBFT internal/consensus/ticker.go).

Only one timeout is pending at a time; scheduling a newer one replaces
the old (ticker.go timeoutRoutine). Fired timeouts go to the
consensus event loop's queue.
"""

from __future__ import annotations

import threading

from ..libs import lockrank

from ..libs.service import BaseService
from .wal import TimeoutInfo


def _newer(a: TimeoutInfo, b: TimeoutInfo) -> bool:
    """Is b for a later (height, round, step) than a?"""
    return (b.height, b.round, b.step) > (a.height, a.round, a.step)


class TimeoutTicker(BaseService):
    def __init__(self, tock):
        """tock: callable receiving the fired TimeoutInfo."""
        super().__init__("TimeoutTicker")
        self._tock = tock
        self._mtx = lockrank.RankedLock("consensus.ticker")
        self._pending: TimeoutInfo | None = None
        self._timer: threading.Timer | None = None
        # clock-skew multiplier on every scheduled duration: 1.0 is an
        # honest clock; >1 runs slow (timeouts fire late), <1 fast.
        # A clock-skew fault injector may set it; nothing else does.
        self.skew = 1.0

    def schedule_timeout(self, ti: TimeoutInfo) -> None:
        """Replace any pending timeout with ti if ti is newer (or always
        for a fresh height/round step reset)."""
        with self._mtx:
            if self._pending is not None and not _newer(self._pending, ti):
                # ticker.go ignores stale schedules except same-HRS resets
                if (ti.height, ti.round, ti.step) != (
                        self._pending.height, self._pending.round,
                        self._pending.step):
                    return
            if self._timer is not None:
                self._timer.cancel()
            self._pending = ti
            self._timer = threading.Timer(
                max(ti.duration_ns, 0) / 1e9 * max(self.skew, 0.0),
                self._fire, args=(ti,))
            self._timer.daemon = True
            self._timer.start()

    def _fire(self, ti: TimeoutInfo) -> None:
        with self._mtx:
            if self._pending is not ti:
                return
            self._pending = None
            self._timer = None
        if self.is_running():
            self._tock(ti)

    def on_start(self) -> None:
        pass

    def on_stop(self) -> None:
        with self._mtx:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            self._pending = None


class ManualTicker:
    """Deterministic ticker for tests: timeouts fire only when the test
    calls fire() (CometBFT uses mocked tickers in state_test.go)."""

    def __init__(self, tock=None):
        self._tock = tock
        self.scheduled: list[TimeoutInfo] = []

    def set_tock(self, tock):
        self._tock = tock

    def schedule_timeout(self, ti: TimeoutInfo) -> None:
        self.scheduled.append(ti)

    def fire(self, index: int = -1) -> None:
        ti = self.scheduled.pop(index)
        self._tock(ti)

    def fire_matching(self, step: int) -> bool:
        for i, ti in enumerate(self.scheduled):
            if ti.step == step:
                self.fire(i)
                return True
        return False

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass
