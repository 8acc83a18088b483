"""Nanosecond-precision timestamps (the port's copy of
`cometbft_tpu.types.timestamp`).

Go's time.Time carries nanoseconds; consensus signs its proto form
(google.protobuf.Timestamp: seconds + nanos), so timestamps stay integer
(seconds, nanos) — any float detour would corrupt sign-bytes.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from datetime import datetime, timezone

from ..libs import protowire as pw


@dataclass(frozen=True, order=True)
class Timestamp:
    seconds: int = 0
    nanos: int = 0

    def __post_init__(self):
        if not 0 <= self.nanos < 1_000_000_000:
            raise ValueError("nanos out of range")

    @staticmethod
    def now() -> "Timestamp":
        ns = _time.time_ns()
        return Timestamp(ns // 1_000_000_000, ns % 1_000_000_000)

    @staticmethod
    def zero() -> "Timestamp":
        return Timestamp(0, 0)

    def is_zero(self) -> bool:
        return self.seconds == 0 and self.nanos == 0

    def to_proto(self) -> bytes:
        return pw.encode_timestamp(self.seconds, self.nanos)

    @staticmethod
    def from_proto(payload: bytes) -> "Timestamp":
        s, n = pw.decode_timestamp(payload)
        return Timestamp(s, n)

    def add_ns(self, delta_ns: int) -> "Timestamp":
        total = self.seconds * 1_000_000_000 + self.nanos + delta_ns
        return Timestamp(total // 1_000_000_000, total % 1_000_000_000)

    def diff_ns(self, other: "Timestamp") -> int:
        return ((self.seconds - other.seconds) * 1_000_000_000
                + (self.nanos - other.nanos))

    # RFC3339 for JSON interop (CometBFT types/canonical.go TimeFormat)
    def rfc3339(self) -> str:
        dt = datetime.fromtimestamp(self.seconds, tz=timezone.utc)
        base = dt.strftime("%Y-%m-%dT%H:%M:%S")
        if self.nanos:
            frac = f"{self.nanos:09d}".rstrip("0")
            return f"{base}.{frac}Z"
        return base + "Z"

    @staticmethod
    def from_rfc3339(s: str) -> "Timestamp":
        """Parse RFC3339 with up to nanosecond fractions (the RPC's time
        format); an offset other than Z is applied."""
        s = s.strip()
        if s.endswith("Z"):
            s = s[:-1] + "+00:00"
        frac_nanos = 0
        if "." in s:
            head, rest = s.split(".", 1)
            for i, c in enumerate(rest):
                if c in "+-":
                    frac, off = rest[:i], rest[i:]
                    break
            else:
                frac, off = rest, "+00:00"
            frac_nanos = int(frac.ljust(9, "0")[:9])
            s = head + off
        dt = datetime.fromisoformat(s)
        return Timestamp(int(dt.timestamp()), frac_nanos)
