"""Nanosecond-precision timestamps (the port's copy of
`cometbft_tpu.types.timestamp`, trimmed to what sign-bytes need).

Go's time.Time carries nanoseconds; consensus signs its proto form
(google.protobuf.Timestamp: seconds + nanos), so timestamps stay integer
(seconds, nanos) — any float detour would corrupt sign-bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..libs import protowire as pw


@dataclass(frozen=True, order=True)
class Timestamp:
    seconds: int = 0
    nanos: int = 0

    def __post_init__(self):
        if not 0 <= self.nanos < 1_000_000_000:
            raise ValueError("nanos out of range")

    @staticmethod
    def zero() -> "Timestamp":
        return Timestamp(0, 0)

    def is_zero(self) -> bool:
        return self.seconds == 0 and self.nanos == 0

    def to_proto(self) -> bytes:
        return pw.encode_timestamp(self.seconds, self.nanos)

    def add_ns(self, delta_ns: int) -> "Timestamp":
        total = self.seconds * 1_000_000_000 + self.nanos + delta_ns
        return Timestamp(total // 1_000_000_000, total % 1_000_000_000)
