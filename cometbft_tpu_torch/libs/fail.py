"""Deterministic crash-point injection (the port's copy of
`cometbft_tpu.libs.fail`; CometBFT internal/fail/fail.go).

Named fail points are sprinkled through the commit sequence
(state/execution.py); setting FAIL_TEST_INDEX to the
ordinal of a call makes the process exit there, so tests can replay a
crash at every window of the save->WAL->apply->save ordering.
"""

from __future__ import annotations

import os

_call_index = -1
_callback = None


def reset() -> None:
    global _call_index, _callback
    _call_index = -1
    _callback = None


def set_callback(cb) -> None:
    """Tests can install a callback instead of killing the process."""
    global _callback
    _callback = cb


def fail_point(name: str = "") -> None:
    """fail.Fail(): exit (or invoke the test callback) when this is the
    FAIL_TEST_INDEX-th fail point hit since process start."""
    env = os.environ.get("FAIL_TEST_INDEX")
    if env is None and _callback is None:
        return
    global _call_index
    _call_index += 1
    if _callback is not None:
        _callback(_call_index, name)
        return
    if _call_index == int(env):
        os._exit(1)
