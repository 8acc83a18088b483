"""State carried between the JAX package and the port.

This system runs no model; its state is the packed batch (the numpy
arrays of crypto/ed25519.pack_rlc and pack_batch, and of
crypto/secp256k1.pack_batch and pack_msm_batch, byte-identical in both
packages), a validator set's A-side window tables (ATableCache entries:
(17, 4, 20, K) int32 plus an all-decompressed-ok flag) and its
secp256k1 key tables (QTableCache entries: (52, 16, 3, 22, K) and
(3, 22, K) int32).  These functions turn the JAX package's numpy forms
into the port's tensors on a given device; uint32 words travel as their
int32 bit patterns.  The secp256k1 arrays reach a card from pinned host
memory without waiting for its queue, so that a program launched on
them makes the host wait for the card no time.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(arr, dtype) -> torch.Tensor:
    """numpy -> CPU tensor sharing memory where it can (a read-only or
    strided array is copied once)."""
    return torch.from_numpy(np.require(arr, dtype=dtype,
                                       requirements=["C", "W"]))


def words_from_numpy(words: np.ndarray, device) -> torch.Tensor:
    """uint32 words of any shape (the packers' (8, W) encodings, the
    (N, B, 16) SHA-2 blocks) -> int32 bit-pattern tensor on `device`."""
    arr = np.require(words, dtype=np.uint32, requirements=["C"])
    return _tensor(arr.view(np.int32), np.int32).to(device)


def packed_from_numpy(packed, device):
    """pack_rlc's (a_words, r_words, a_mag, a_neg, r_mag, r_neg) -> the
    argument tuple of ops/ed25519.rlc_verify_kernel on `device`."""
    a_words, r_words, a_mag, a_neg, r_mag, r_neg = packed
    return (words_from_numpy(a_words, device),
            words_from_numpy(r_words, device),
            _tensor(a_mag, np.int32).to(device),
            _tensor(a_neg, bool).to(device),
            _tensor(r_mag, np.int32).to(device),
            _tensor(r_neg, bool).to(device))


def batch_from_numpy(a_words, r_words, s_limbs, h_limbs, device):
    """pack_batch's limbs-first arrays -> ops/ed25519.verify_kernel's
    arguments on `device`."""
    return (words_from_numpy(a_words, device),
            words_from_numpy(r_words, device),
            _tensor(s_limbs, np.int32).to(device),
            _tensor(h_limbs, np.int32).to(device))


def a_table_from_numpy(a_tab, a_ok, device):
    """An A-side table built by either package ((17, 4, 20, K) int32 and
    its ok flag, as numpy) -> the (table, ok) entry the port's
    rlc_verify_kernel_cached_a takes."""
    return (_tensor(a_tab, np.int32).to(device),
            torch.tensor(bool(np.asarray(a_ok)), device=device))


def rlc_hash_from_numpy(packed, device):
    """pack_rlc_device_hash's ten arrays -> the argument tuple of
    ops/ed25519.rlc_verify_hash_kernel on `device`: words and SHA-512
    blocks as int32 bit patterns, scalar limbs as int64."""
    (a_words, r_words, base_limbs, z_limbs, group_ids,
     blocks_hi, blocks_lo, n_blocks, r_mag, r_neg) = packed
    return (words_from_numpy(a_words, device),
            words_from_numpy(r_words, device),
            _tensor(base_limbs, np.int64).to(device),
            _tensor(z_limbs, np.int64).to(device),
            _tensor(group_ids, np.int64).to(device),
            words_from_numpy(blocks_hi, device),
            words_from_numpy(blocks_lo, device),
            _tensor(n_blocks, np.int32).to(device),
            _tensor(r_mag, np.int32).to(device),
            _tensor(r_neg, bool).to(device))


def batch_hash_from_numpy(a_words, r_words, s_limbs, blocks_hi, blocks_lo,
                          n_blocks, device):
    """pack_batch_device_hash's arrays -> ops/ed25519.verify_hash_kernel's
    arguments on `device`."""
    return (words_from_numpy(a_words, device),
            words_from_numpy(r_words, device),
            _tensor(s_limbs, np.int32).to(device),
            words_from_numpy(blocks_hi, device),
            words_from_numpy(blocks_lo, device),
            _tensor(n_blocks, np.int32).to(device))


def to_device_async(arr, dtype, device) -> torch.Tensor:
    """numpy -> `dtype` tensor on `device`; to a card through pinned host
    memory, a copy that does not make the host wait for the card."""
    t = _tensor(arr, dtype)
    dev = torch.device(device)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def secp_batch_from_numpy(packed, device):
    """crypto/secp256k1.pack_batch's (qx, qy, u1_nibs, u2_nibs, r_limbs,
    rn_limbs, rn_valid) -> ops/secp256k1.verify_kernel's arguments on
    `device`."""
    *limbs, rn_valid = packed
    return tuple(to_device_async(x, np.int32, device) for x in limbs) + \
        (to_device_async(rn_valid, bool, device),)


SECP_MSM_KEYS = ("gid", "g_rows", "g_neg", "q_rows", "q_neg", "r_limbs",
                 "rn_limbs", "rn_valid", "s_pt")


def secp_msm_from_numpy(pk: dict, device):
    """crypto/secp256k1.pack_msm_batch's dict -> the arguments of
    ops/secp256k1.msm_verify_kernel after the key tables (gid ... s_pt)
    on `device`."""
    return tuple(to_device_async(pk[k], bool if pk[k].dtype == bool
                                 else np.int32, device)
                 for k in SECP_MSM_KEYS)


def q_tables_from_numpy(qtab, q_corr, device):
    """Key tables built by either package ((52, 16, 3, 22, K) and
    (3, 22, K) int32, as numpy) -> the (qtab, q_corr) tensors the port's
    msm_verify_kernel takes."""
    return (_tensor(qtab, np.int32).to(device),
            _tensor(q_corr, np.int32).to(device))
