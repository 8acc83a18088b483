"""CRC-32C (Castagnoli, poly 0x1EDC6F41 reflected = 0x82F63B78): the
port's copy of `cometbft_tpu.libs.crc32c`.

The WAL record checksum (CometBFT internal/consensus/wal.go uses
crc32.MakeTable(crc32.Castagnoli)). Table-driven; records are small
(votes ~200 B) so pure Python is fine on the host path.
"""

from __future__ import annotations

_POLY = 0x82F63B78


def _make_table() -> list[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _make_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF
