"""BatchVerifier for the port: the accelerator seam of commit
verification, ed25519 only (the counterpart of
`cometbft_tpu.crypto.batch`).

- CudaEd25519BatchVerifier packs the batch and runs the RLC program on
  its device (kernels K1-K4 on a card, their plain versions for
  device="cpu"); on a reject the per-signature program localizes the bad
  signatures — CometBFT's verifyCommitBatch -> verifyCommitSingle
  pattern.
- CpuEd25519BatchVerifier is the host loop (pure-Python ZIP-215),
  used below the device threshold.

create_batch_verifier resolves its device first: without a card it
raises unless the caller asks for device="cpu".
"""

from __future__ import annotations

import os
from typing import Protocol

from . import ed25519 as ed


class BatchVerifier(Protocol):
    def add(self, pubkey, msg: bytes, sig: bytes) -> None: ...
    def verify(self) -> tuple[bool, list[bool]]: ...
    def count(self) -> int: ...


class _SigCollector:
    """Shared add/count scaffolding: items are (pubkey_bytes, msg, sig)."""

    def __init__(self):
        self._items: list[tuple[bytes, bytes, bytes]] = []

    def add(self, pubkey, msg: bytes, sig: bytes) -> None:
        pk = pubkey.bytes() if hasattr(pubkey, "bytes") else bytes(pubkey)
        self._items.append((pk, msg, sig))

    def count(self) -> int:
        return len(self._items)


class CpuEd25519BatchVerifier(_SigCollector):
    """ZIP-215 host loop (crypto/ed25519_ref)."""

    def verify(self) -> tuple[bool, list[bool]]:
        from . import ed25519_ref as ref

        verdicts = [bool(ref.verify(pk, m, s)) for pk, m, s in self._items]
        return all(verdicts) and bool(verdicts), verdicts


class CudaEd25519BatchVerifier(_SigCollector):
    """Packs the batch and runs the device programs on `device`."""

    def __init__(self, device):
        super().__init__()
        self.device = device

    def verify(self) -> tuple[bool, list[bool]]:
        if not self._items:
            return False, []
        pks = [i[0] for i in self._items]
        # parse + hash ONCE; both packings build from this
        parsed = ed.parse_and_hash(pks, [i[1] for i in self._items],
                                   [i[2] for i in self._items])
        return _device_verify(pks, parsed, self.device)


def _placed(device) -> bool:
    """A dispatch is placed when it names one device: "cuda:N" or
    "cpu".  The un-indexed "cuda" is the JAX package's device=None: the
    current card, or a split over the mesh when one is configured."""
    return device.type != "cuda" or device.index is not None


def _device_verify(pubkeys: list[bytes], parsed,
                   device) -> tuple[bool, list[bool]]:
    """RLC fast path first (one verdict for the batch), the
    per-signature program for verdict localization on failure.

    A placed dispatch runs both on `device`.  An un-placed one splits a
    large batch over the mesh first (crypto/mesh.maybe_split_verify:
    one RLC program per device) and localizes with the per-signature
    program split over the mesh, or with the mesh off over every local
    card, as the JAX package does (ops/sharding.verify_batch_sharded)."""
    from ..ops import sharding
    from . import mesh

    n = len(pubkeys)
    placed = _placed(device)
    if n >= 2:
        rlc_ok = None if placed else mesh.maybe_split_verify(pubkeys, parsed)
        if rlc_ok is None:
            packed = ed.pack_rlc(pubkeys, [b""] * n, [b""] * n,
                                 parsed=parsed)
            rlc_ok = packed is not None and ed.rlc_verify(packed,
                                                          device=device)
        if rlc_ok:
            return True, [True] * n
    devices = [device] if placed else mesh.mesh_devices()
    bucket = sharding.auto_bucket(n, None if devices is None else len(devices))
    a, r, s, h, valid = ed.pack_batch(pubkeys, [b""] * n, [b""] * n,
                                      bucket, parsed=parsed)
    verdict = sharding.verify_batch_sharded(a, r, s, h, devices=devices)
    out = (verdict.cpu().numpy() & valid)[:n].tolist()
    return all(out) and bool(out), out


# below this many signatures the host loop wins (CometBFT's analog is
# batchVerifyThreshold = 2; the device round-trip has a fixed cost)
DEVICE_THRESHOLD = int(os.environ.get("COMETBFT_TPU_BATCH_THRESHOLD", "8"))


def safe_verify(pub_key, msg: bytes, sig: bytes) -> bool:
    """verify_signature with backend errors mapped to invalid: the one
    rule every host single-verify loop follows."""
    try:
        return bool(pub_key.verify_signature(msg, sig))
    except Exception:
        return False


_SUPPORTED = {"ed25519"}


def supports_batch_verifier(key_type: str) -> bool:
    return key_type in _SUPPORTED


def create_batch_verifier(key_type: str = "ed25519", n_hint: int = 0,
                          device="cuda") -> BatchVerifier:
    """The host loop below DEVICE_THRESHOLD expected signatures
    (n_hint), else the device programs on `device`."""
    from ..ops import device as devmod

    dev = devmod.resolve(device)
    if key_type not in _SUPPORTED:
        raise ValueError(f"no batch verifier for key type {key_type}")
    if n_hint and n_hint < DEVICE_THRESHOLD:
        return CpuEd25519BatchVerifier()
    return CudaEd25519BatchVerifier(dev)
