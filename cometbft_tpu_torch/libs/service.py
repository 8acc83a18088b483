"""Uniform start / stop lifecycle for long-lived objects
(CometBFT's libs/service/service.go), as the JAX package has it.

Start once, stop once.  The verify pipeline (crypto/dispatch.py) is
the port's first long-lived service.
"""

from __future__ import annotations

from . import lockrank


class AlreadyStartedError(RuntimeError):
    pass


class AlreadyStoppedError(RuntimeError):
    pass


class BaseService:
    """Template-method lifecycle: subclasses override on_start/on_stop."""

    def __init__(self, name: str = ""):
        self._name = name or type(self).__name__
        self._started = False
        self._stopped = False
        self._lifecycle_mtx = lockrank.RankedLock("service.lifecycle")

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._lifecycle_mtx:
            if self._started:
                raise AlreadyStartedError(self._name)
            if self._stopped:
                raise AlreadyStoppedError(self._name)
            self._started = True
        self.on_start()

    def stop(self) -> None:
        with self._lifecycle_mtx:
            if self._stopped:
                return
            self._stopped = True
        self.on_stop()

    def is_running(self) -> bool:
        return self._started and not self._stopped

    # -- overridables ------------------------------------------------------
    def on_start(self) -> None:  # pragma: no cover - trivial default
        pass

    def on_stop(self) -> None:  # pragma: no cover - trivial default
        pass
