"""BatchVerifier for the port: the accelerator seam of commit
verification, by key type (the counterpart of `cometbft_tpu.crypto.batch`).

- CudaEd25519BatchVerifier packs the batch and runs the RLC program on
  its device (kernels K1-K4 on a card, their plain versions for
  device="cpu"); on a reject the per-signature program localizes the bad
  signatures — CometBFT's verifyCommitBatch -> verifyCommitSingle
  pattern.
- CudaSecp256k1BatchVerifier runs the secp256k1 MSM program (K11 tables
  through the QTableCache, K12), or with COMETBFT_TPU_SECP_MSM=0 the
  ladder (K13); its verdicts are per signature.
- CudaSr25519BatchVerifier runs sr25519 on the ed25519 programs: the
  host decodes each ristretto point and re-encodes it in Edwards form,
  and the Merlin challenge takes SHA-512's place
  (crypto/sr25519.to_edwards_inputs); then _device_verify, as ed25519.
- CpuEd25519BatchVerifier / CpuSecp256k1BatchVerifier /
  CpuSr25519BatchVerifier are the host loops (pure Python), used below
  the device threshold of their key type or when
  COMETBFT_TPU_PROVIDER=cpu.
- Every verifier's verify() inserts the verdicts it computed into the
  signature-verdict cache (crypto/sigcache), under its key type;
  consulting the cache is the callers' part (types/validation,
  safe_verify).
- MixedBatchVerifier splits a mixed-key batch by key type, runs each
  type's verifier (concurrently when there are several) and merges the
  verdicts in insertion order; a key type with no batch verifier is
  verified singly.
- _device_verify_hash is the device-hash route: hashing, aggregation
  and recode run on the device as well.  In the JAX package its
  pipeline takes this route under COMETBFT_TPU_DEVICE_HASH=1; the
  pipeline is not ported, so no variable selects it here and a caller
  calls the function itself.

create_batch_verifier resolves its device first: without a card it
raises unless the caller asks for device="cpu".
"""

from __future__ import annotations

import os
from typing import Protocol

from . import ed25519 as ed
from . import sigcache


class BatchVerifier(Protocol):
    def add(self, pubkey, msg: bytes, sig: bytes) -> None: ...
    def verify(self) -> tuple[bool, list[bool]]: ...
    def count(self) -> int: ...


class _SigCollector:
    """Shared add/count scaffolding: items are (pubkey_bytes, msg, sig).
    verify() wraps the subclass's _verify_items() and inserts every
    verdict into the signature-verdict cache under KEY_TYPE."""

    KEY_TYPE = "ed25519"

    def __init__(self):
        self._items: list[tuple[bytes, bytes, bytes]] = []

    def add(self, pubkey, msg: bytes, sig: bytes) -> None:
        pk = pubkey.bytes() if hasattr(pubkey, "bytes") else bytes(pubkey)
        self._items.append((pk, msg, sig))

    def count(self) -> int:
        return len(self._items)

    def verify(self) -> tuple[bool, list[bool]]:
        ok, verdicts = self._verify_items()
        if self._items:
            sigcache.insert_many(self._items, verdicts,
                                 key_type=self.KEY_TYPE)
        return ok, verdicts


class _CpuLoopVerifier(_SigCollector):
    """Host per-signature loop; subclasses provide _check(pk, msg, sig),
    a ValueError counting as a reject."""

    def _verify_items(self) -> tuple[bool, list[bool]]:
        verdicts = []
        for pk, m, s in self._items:
            try:
                verdicts.append(bool(self._check(pk, m, s)))
            except ValueError:
                verdicts.append(False)
        return all(verdicts) and bool(verdicts), verdicts


class CpuEd25519BatchVerifier(_CpuLoopVerifier):
    """ZIP-215 host loop (crypto/ed25519_ref)."""

    def _check(self, pk, m, s):
        from . import ed25519_ref as ref
        return ref.verify(pk, m, s)


class CpuSecp256k1BatchVerifier(_CpuLoopVerifier):
    """ECDSA host loop (crypto/secp256k1._verify_py)."""

    KEY_TYPE = "secp256k1"

    def _check(self, pk, m, s):
        from . import secp256k1 as sk
        return sk.PubKey(pk).verify_signature(m, s)


class CudaEd25519BatchVerifier(_SigCollector):
    """Packs the batch and runs the device programs on `device`."""

    def __init__(self, device):
        super().__init__()
        self.device = device

    def _verify_items(self) -> tuple[bool, list[bool]]:
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
    card, as the JAX package does (ops/sharding.verify_batch_sharded):
    over the split's bucket where there are several devices, else over
    the live lanes (ops/sharding.localization_width)."""
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
    width = sharding.localization_width(
        n, None if devices is None else len(devices))
    a, r, s, h, valid = ed.pack_batch(pubkeys, [b""] * n, [b""] * n,
                                      width, parsed=parsed)
    verdict = sharding.verify_batch_sharded(a, r, s, h, devices=devices)
    out = (verdict.cpu().numpy() & valid)[:n].tolist()
    return all(out) and bool(out), out


_NO_PACK = object()


def _device_verify_hash(pubkeys: list[bytes], msgs: list[bytes], parsed,
                        packed=_NO_PACK,
                        device="cuda") -> tuple[bool, list[bool]]:
    """_device_verify with device-side hash-to-scalar: SHA-512 (K9), the
    reduction mod L, the per-pubkey aggregation and the A-side recode
    run on the device (ops/ed25519.rlc_verify_hash_kernel), and so does
    the per-signature localization on a reject (verify_hash_kernel):
    no digest crosses back to the host.  `parsed` is a parse_batch
    result ((r_enc, s) | None, no h); `packed` a pack_rlc_device_hash
    result made ahead of time.

    An un-placed dispatch ("cuda", no index) splits a large batch over
    the mesh first (crypto/mesh.maybe_split_verify_hash); localization
    runs on one device, as in the JAX package, over the n live lanes.
    Raises ValueError("message exceeds max_blocks") when a message
    outgrows the static block bucket."""
    from .. import convert
    from ..ops import device as devmod
    from ..ops import ed25519 as dev
    from . import mesh

    device = devmod.resolve(device)
    n = len(pubkeys)
    if n >= 2:
        rlc_ok = None
        if packed is _NO_PACK and not _placed(device):
            rlc_ok = mesh.maybe_split_verify_hash(pubkeys, msgs, parsed)
        if rlc_ok is None:
            if packed is _NO_PACK:
                packed = ed.pack_rlc_device_hash(pubkeys, msgs, [b""] * n,
                                                 parsed=parsed)
            rlc_ok = packed is not None and ed.rlc_verify_hash(
                packed, device=device)
        if rlc_ok:
            return True, [True] * n
    a, r, s, bh, bl, nb, valid = ed.pack_batch_device_hash(
        pubkeys, msgs, [b""] * n, n, parsed=parsed)
    verdict = dev.verify_hash_kernel(*convert.batch_hash_from_numpy(
        a, r, s, bh, bl, nb, device))
    out = (verdict.cpu().numpy() & valid)[:n].tolist()
    return all(out) and bool(out), out


class CudaSecp256k1BatchVerifier(_SigCollector):
    """ECDSA batch on `device`.  By default the MSM program: u1*G from a
    static G table and u2*Q from per-key tables the QTableCache keeps on
    the device (K11 on a miss, then K12).  COMETBFT_TPU_SECP_MSM=0 takes
    the per-signature ladder (K13) instead, as in the JAX package.  ECDSA
    has no whole-batch equation, so the verdicts are per signature and a
    reject needs no localization round.  An un-placed dispatch ("cuda",
    no index) splits a large batch over the mesh first
    (crypto/mesh.maybe_split_secp_verify)."""

    KEY_TYPE = "secp256k1"

    def __init__(self, device):
        super().__init__()
        self.device = device

    def _verify_items(self) -> tuple[bool, list[bool]]:
        from ..ops import ed25519 as ed_dev
        from ..ops import secp256k1 as dev
        from . import mesh
        from . import secp256k1 as sk

        n = len(self._items)
        if n == 0:
            return False, []
        pubkeys = [i[0] for i in self._items]
        msgs = [i[1] for i in self._items]
        sigs = [i[2] for i in self._items]
        if sk.msm_enabled():
            out = None if _placed(self.device) else \
                mesh.maybe_split_secp_verify(pubkeys, msgs, sigs)
            if out is None:
                out = sk.verify_msm_batch(pubkeys, msgs, sigs,
                                          device=self.device)
            return all(out) and bool(out), out
        packed = sk.pack_batch(pubkeys, msgs, sigs, ed_dev.bucket_size(n))
        verdict = dev.verify_batch_device(*packed[:-1], device=self.device)
        out = (verdict.cpu().numpy() & packed[-1])[:n].tolist()
        return all(out) and bool(out), out


class CpuSr25519BatchVerifier(_CpuLoopVerifier):
    """Schnorrkel host loop (crypto/sr25519.PubKey.verify_signature)."""

    KEY_TYPE = "sr25519"

    def _check(self, pk, m, s):
        from . import sr25519 as sr
        return sr.PubKey(pk).verify_signature(m, s)


class CudaSr25519BatchVerifier(_SigCollector):
    """sr25519 batches on the ed25519 programs on `device`: each A and R
    decoded from ristretto on the host and re-encoded in Edwards form,
    the Merlin challenge in place of SHA-512's h
    (crypto/sr25519.to_edwards_inputs), then _device_verify as for
    ed25519 (RLC program, localization on a reject).  A structural
    reject becomes a zero key and no parse, so its lane is invalid."""

    KEY_TYPE = "sr25519"

    def __init__(self, device):
        super().__init__()
        self.device = device

    def _verify_items(self) -> tuple[bool, list[bool]]:
        from . import sr25519 as sr

        if not self._items:
            return False, []
        ed_pubs, parsed = [], []
        for pk, m, s in self._items:
            t = sr.to_edwards_inputs(pk, m, s)
            if t is None:
                ed_pubs.append(b"\x00" * 32)
                parsed.append(None)
            else:
                a_ed, r_ed, s_int, k = t
                ed_pubs.append(a_ed)
                parsed.append((r_ed, s_int, k))
        return _device_verify(ed_pubs, parsed, self.device)


# below this many signatures the host loop wins (CometBFT's analog is
# batchVerifyThreshold = 2; the device round-trip has a fixed cost)
DEVICE_THRESHOLD = int(os.environ.get("COMETBFT_TPU_BATCH_THRESHOLD", "8"))

# secp256k1 has no whole-batch equation, so its device advantage starts
# at larger batches: the JAX package's crossover, never below
# DEVICE_THRESHOLD
SECP_DEVICE_THRESHOLD = int(os.environ.get(
    "COMETBFT_TPU_SECP_THRESHOLD", "96"))


def _device_threshold(key_type: str) -> int:
    if key_type == "secp256k1":
        return max(DEVICE_THRESHOLD, SECP_DEVICE_THRESHOLD)
    return DEVICE_THRESHOLD


def safe_verify(pub_key, msg: bytes, sig: bytes) -> bool:
    """verify_signature with backend errors mapped to invalid: the one
    rule every host single-verify loop follows.  It goes through the
    signature-verdict cache: a triple verified anywhere in the process
    answers here for one SHA-256, and a fresh verdict is inserted."""
    v = sigcache.get(pub_key, msg, sig)
    if v is not None:
        return v
    try:
        v = bool(pub_key.verify_signature(msg, sig))
    except Exception:
        v = False
    sigcache.insert(pub_key, msg, sig, v)
    return v


# the key types the port batches, as the JAX package does
_SUPPORTED = {"ed25519", "sr25519", "secp256k1"}

_CPU_BY_TYPE = {"ed25519": CpuEd25519BatchVerifier,
                "sr25519": CpuSr25519BatchVerifier,
                "secp256k1": CpuSecp256k1BatchVerifier}
_CUDA_BY_TYPE = {"ed25519": CudaEd25519BatchVerifier,
                 "sr25519": CudaSr25519BatchVerifier,
                 "secp256k1": CudaSecp256k1BatchVerifier}


def supports_batch_verifier(key_type: str) -> bool:
    return key_type in _SUPPORTED


def create_batch_verifier(key_type: str = "ed25519", n_hint: int = 0,
                          device="cuda",
                          provider: str | None = None) -> BatchVerifier:
    """The verifier for `key_type` that `provider` names, as the JAX
    package reads it (argument first, else COMETBFT_TPU_PROVIDER, default
    "auto"): "cpu" is the host loop at any size, "tpu" the device
    programs on `device` at any size, and anything else picks by n_hint:
    the host loop below the key type's device threshold
    (_device_threshold), else the device programs."""
    from ..ops import device as devmod

    dev = devmod.resolve(device)
    provider = provider or os.environ.get("COMETBFT_TPU_PROVIDER", "auto")
    if key_type not in _SUPPORTED:
        raise ValueError(f"no batch verifier for key type {key_type}")
    if provider == "cpu":
        return _CPU_BY_TYPE[key_type]()
    if provider == "tpu":
        return _CUDA_BY_TYPE[key_type](dev)
    if n_hint and n_hint < _device_threshold(key_type):
        return _CPU_BY_TYPE[key_type]()
    return _CUDA_BY_TYPE[key_type](dev)


class MixedBatchVerifier:
    """Routes a mixed-key batch to per-type verifiers on `device` and
    merges their verdicts in insertion order.  CometBFT refuses mixed
    batches; the JAX package batches them, and so does the port.  A key
    type with no batch verifier is verified singly (safe_verify) at
    verify() time."""

    def __init__(self, provider: str | None = None, device="cuda"):
        from ..ops import device as devmod

        self._provider = provider
        self._device = devmod.resolve(device)
        self._items: dict[str, list] = {}
        self._order: list[tuple[str, int] | None] = []
        self._singles: list[tuple[object, bytes, bytes]] = []

    def add(self, pubkey, msg: bytes, sig: bytes) -> None:
        kt = pubkey.type() if hasattr(pubkey, "type") else "ed25519"
        if not supports_batch_verifier(kt):
            self._order.append(None)
            self._singles.append((pubkey, msg, sig))
            return
        items = self._items.setdefault(kt, [])
        self._order.append((kt, len(items)))
        items.append((pubkey, msg, sig))

    def count(self) -> int:
        return len(self._order)

    def _verify_subtype(self, kt: str, items) -> list[bool]:
        sub = create_batch_verifier(kt, n_hint=len(items),
                                    device=self._device,
                                    provider=self._provider)
        for pk, msg, sig in items:
            sub.add(pk, msg, sig)
        return sub.verify()[1]

    def verify(self) -> tuple[bool, list[bool]]:
        """Each key type's verifier is made here, so that n_hint routes a
        small sub-batch (a lone secp256k1 validator in an ed25519 set) to
        the host loop.  Sub-batches of different key types are
        independent programs: with more than one they run in a thread
        pool, one thread a type, as in the JAX package."""
        if len(self._items) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                    max_workers=len(self._items),
                    thread_name_prefix="mixed-batch") as ex:
                futs = {kt: ex.submit(self._verify_subtype, kt, items)
                        for kt, items in self._items.items()}
                results = {kt: f.result() for kt, f in futs.items()}
        else:
            results = {kt: self._verify_subtype(kt, items)
                       for kt, items in self._items.items()}
        singles = iter(self._singles)
        out = []
        for slot in self._order:
            if slot is None:
                pk, msg, sig = next(singles)
                out.append(safe_verify(pk, msg, sig))
            else:
                kt, i = slot
                out.append(results[kt][i])
        return all(out) and bool(out), out
