"""tmhash: SHA-256 and its 20-byte truncation, with bulk SHA-256 on the
card — the port's counterpart of `cometbft_tpu.crypto.hash`.

Single hashes use hashlib.  sum_sha256_many pads a large batch on the
host and hashes it in one launch of kernel K10 (ops/sha2.py); below
DEVICE_HASH_THRESHOLD messages the transfer costs more than hashlib.
"""

from __future__ import annotations

import hashlib
import os

TRUNCATED_SIZE = 20

# below this many messages the device round-trip costs more than hashlib
DEVICE_HASH_THRESHOLD = int(os.environ.get(
    "COMETBFT_TPU_HASH_THRESHOLD", "512"))


def sum_sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def sum_truncated(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()[:TRUNCATED_SIZE]


def sum_sha256_many(msgs: list[bytes], device="cuda") -> list[bytes]:
    """Batched SHA-256: one K10 launch on `device` (its plain version for
    device="cpu") for DEVICE_HASH_THRESHOLD messages and more, hashlib
    below.  The device is resolved first, so without a card this raises
    unless device="cpu"."""
    import numpy as np
    import torch

    from .. import convert
    from ..ops import device as devmod
    from ..ops import sha2

    dev = devmod.resolve(device)
    if len(msgs) < DEVICE_HASH_THRESHOLD:
        return [hashlib.sha256(m).digest() for m in msgs]
    blocks, n_blocks = sha2.pad_sha256(msgs)
    digests = sha2.sha256_blocks(convert.words_from_numpy(blocks, dev),
                                 torch.from_numpy(n_blocks).to(dev))
    raw = (digests.cpu().numpy().view(np.uint32)).astype(">u4").tobytes()
    return [raw[32 * i:32 * i + 32] for i in range(len(msgs))]
