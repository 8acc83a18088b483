#!/usr/bin/env python3
"""Count the times the RLC verify programs make the host wait for the
card, stage by stage, for one checkout.

    python3 cometbft_tpu_torch/tools/host_syncs.py [--root DIR]

Run it as a file, not with -m.  --root is the checkout whose
`cometbft_tpu_torch` is imported (default: the one holding this
script), so that two trees can be compared in one call on one card.

A program that never waits can be launched on every chunk of a split
window before any verdict is read.  The count is torch's sync debug
mode in its "warn" setting: each warning "called a synchronizing CUDA
operation" is one wait.  The inputs (12 signatures of ed25519_ref over
seeded keys, 10 distinct) are copied to the card first and each
program runs once before it is counted.  The counted stages are the
device-hash program (ops/ed25519.rlc_verify_hash_kernel) whole and
each of its hash-to-scalar steps, the host-hash program
(rlc_verify_kernel) whole, and the secp256k1 MSM dispatch
(crypto/secp256k1.verify_msm_async: pack, key-table lookup, copies and
K12, over 12 signatures of 4 keys) with its key tables cached.  A
control, one copy of a numpy array to the card, must count 1.  Prints
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import warnings
from pathlib import Path

SYNC_WARNING = "called a synchronizing CUDA operation"


def count_waits(torch, fn, *args):
    """(times fn(*args) made the host wait for the card, its result),
    with the card idle before and after."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum(SYNC_WARNING in str(w.message) for w in caught), out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.crypto import secp256k1 as sk
    from cometbft_tpu_torch.ops import ed25519 as dev
    from cometbft_tpu_torch.ops import scalar25519 as sc
    from cometbft_tpu_torch.ops import sha2

    if not torch.cuda.is_available():
        print("host_syncs: no CUDA device", file=sys.stderr)
        return 2
    card = torch.device("cuda")

    def waits(fn, *a):
        fn(*a)                                 # constants reach the card
        return count_waits(torch, fn, *a)[0]

    seeds = [bytes([i % 10]) * 32 for i in range(12)]
    pks = [ref.pubkey_from_seed(s) for s in seeds]
    msgs = [b"vote %d " % i * 12 for i in range(12)]
    sigs = [ref.sign(s, m) for s, m in zip(seeds, msgs)]
    t = convert.rlc_hash_from_numpy(ed.pack_rlc_device_hash(pks, msgs, sigs),
                                    card)
    a_words, _, base, z, gid, bh, bl, nb, _, _ = t
    th = convert.packed_from_numpy(
        ed.pack_rlc(pks, msgs, sigs, parsed=ed.parse_and_hash(pks, msgs, sigs)),
        card)
    h = dev._h_scalars(bh, bl, nb)
    sh, sl = sha2.sha512_blocks(bh, bl, nb)
    wide = sc.digest512_to_wide_limbs(sh, sl)
    zh = dev._zh_mod_l(z.long(), h)
    seg = dev._segment_sum_mod_l(zh, gid, a_words.shape[-1])
    k = dev._add_mod_l(base.long(), seg)
    keys = [sk.PrivKey.generate(bytes([i % 4]) * 32) for i in range(12)]
    secp = ([k.pub_key().bytes() for k in keys], msgs,
            [k.sign(m) for k, m in zip(keys, msgs)])
    rec = {
        "root": args.root, "torch": torch.__version__,
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(),
        "verdicts": [bool(dev.rlc_verify_hash_kernel(*t)),
                     bool(dev.rlc_verify_kernel(*th))],
        "control_one_copy": waits(
            lambda: torch.as_tensor(np.arange(4), device=card)),
        "device_hash_program": waits(dev.rlc_verify_hash_kernel, *t),
        "stages": {
            "k9": waits(sha2.sha512_blocks, bh, bl, nb),
            "digest_to_limbs": waits(sc.digest512_to_wide_limbs, sh, sl),
            "barrett": waits(sc.barrett_reduce_wide, wide),
            "zh_mod_l": waits(dev._zh_mod_l, z.long(), h),
            "segment_sum_mod_l": waits(dev._segment_sum_mod_l, zh, gid,
                                       a_words.shape[-1]),
            "add_mod_l": waits(dev._add_mod_l, base.long(), seg),
            "recode_w5": waits(dev._recode_w5_device, k)},
        "host_hash_program": waits(dev.rlc_verify_kernel, *th),
        "secp_verify_msm_async": waits(sk.verify_msm_async, *secp)}
    print(json.dumps(rec), flush=True)
    return 0 if rec["control_one_copy"] == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
