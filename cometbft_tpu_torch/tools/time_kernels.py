#!/usr/bin/env python3
"""Time the port's kernels K1 (decompress), K2 (table17_neg), K3
(msm_window_major), K4 (fold_verify), K5 (msm_window_major_grouped), K6
(msm_window_loop), K7 (select_tree), K11 (secp_q_tables), K12
(secp_msm_verify), K13 (secp_ladder) and K14 (ed25519_verify_ladder) of
one checkout on the card, at
the main path's widths, and optionally count the instruction mix of K1's
and K2's longest loops.

    python3 cometbft_tpu_torch/tools/time_kernels.py [--root DIR] [--sass]
        [--k14 | --sha]

Run it as a file, not with -m.  --root is the checkout whose
`cometbft_tpu_torch` is imported and built (default: the one holding
this script), so that two commits can be
compared in one call on one card: unpack the other with `git archive`
into a gitignored directory and run parent, change, change, parent.

The inputs come from a seeded generator on the card, so every checkout
gets the same words: random 32-byte encodings (about half decode) at
W = 128, 5120, 8192 and 10240 lanes, the widths K1 and K2 take on the
main path; K2 takes K1's points.  K1 and K2 are launched through the
library's C functions into preallocated outputs (the wrappers' Python
work, some tens of microseconds a call, would otherwise be what is timed
at the small widths); K3, at 52 windows on the A-side widths (128,
10240) and 26 on the R-side ones (5120, 8192), with random digits,
through its wrapper.  K4 is launched through its C function into a
preallocated verdict, at the main path's partial counts (commit 4 + 4,
window 4 + 10, batch 10 + 8; A side decoded points, R side their
negations); K5 the same way into
preallocated window sums and partials, at K3's four shapes with groups
4 and 13 (group_for's 4 / 2 and 13 / 13 on the 52- / 26-window sides),
taking either C interface: with the group (before K5 ran on quads) or
with the window-sum scratch.  K6 and K7 the same way, at K3's four
shapes with the blocks loop_blk gives under BLK 512 and 2048 (K7 on the
first window's digits), K6 taking either C interface: with the window-sum
scratch or without (before K6 ran on quads); a block the checkout's
loop_geometry refuses (more than 8 rows per output lane before K6 and
K7 ran on quads) is recorded as "refused".  Each time is the median over
7 runs of the CUDA-event time of 20 calls made back to back, divided by
20.  Before timing, each kernel is held against its plain version: K1
and K2 at W = 129, K4's verdict on a 10 + 10 set, K5 at 4 windows x 129
lanes, group 2, K6 and K7 at 4 windows x 1,100 lanes (a ragged last
block) with blocks of 512 and 2,048 lanes.  K13 is launched through its
C function into a preallocated verdict at B = 4,096, at chip_smoke.py's
16 edge lanes (taken from the chip_smoke.py beside this script's
package) and at 16,384, each first held against its plain version and
the lanes' own verdicts: 64 lanes from the host's group law (u1, u2
random, Q one of four keys, r = x(u1 G + u2 Q), a third with r + 1),
tiled to the width, 10 calls a run.  K14 the same way at 16, 256,
4,096, 4,848 and 16,384 signatures: 64 real signatures signed on the
host from the seed (a third with s + 1), packed, tiled to the width,
decompressed by K1 on the card, each shape held first against
verify_ladder_plain and the lanes' verdicts; a checkout without K14 is
recorded as "absent".  --k14 times K14 alone.
--sha times K9 (sha512_blocks) and K10 (sha256_blocks) alone, launched
through their C functions into preallocated outputs as chip_smoke.py's
_raw_sha does: K9 at 32 / 128 / 5,120 / 8,192 / 16,384 messages of 3
blocks each (R||A||M lengths 240-367 from a seeded generator), K10 at
32 and 10,000 one-block messages (lengths 0-55) and at 80 messages of
one or two blocks (lengths 0-119), 20 calls a run; each shape is first
held word for word against its plain version and against hashlib, and
the library's ptxas lines (registers, shared memory, stack) come with
the times.
--sass disassembles
the built library with cuobjdump and prints, for each of the two
kernels, the opcode counts of its longest loop (a backward branch and
its target).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

WIDTHS = (128, 5120, 8192, 10240)
SECP_KEYS = (4, 128, 192)                      # K11: keys
SECP_SHAPES = ((256, 128), (4096, 128), (16384, 192))   # K12: (B, K)
LADDER_SHAPES = (4096, 16, 16384)              # K13: B (16: the edge lanes)
PERSIG_SHAPES = (16, 256, 4096, 4848, 16384)   # K14: signatures
SHA512_SHAPES = (32, 128, 5120, 8192, 16384)   # K9: messages, 3 blocks
SHA256_SHAPES = ((32, 1), (10000, 1), (80, 2))  # K10: (messages, B)
K4_SHAPES = ((4, 4), (4, 10), (10, 8))     # commit, window, batch
LOOP_BLKS = (512, 2048)                    # BLK for K6 and K7


def _loop_refused(cm, w, blk):
    """Whether the checkout's loop_geometry refuses blk at width w."""
    try:
        cm.loop_geometry(w, blk)
    except ValueError:
        return True
    return False


def _time(torch, fn, args, reps=7, inner=20):
    fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def _loop_mix(sass: str, kernel: str, key: str | None = None) -> dict:
    """Opcode counts of the longest loop of `kernel` (the SASS section of
    the entry function whose mangled name starts with _Z<len><kernel>, or
    holds `key` where given, with the device functions it calls that
    follow it)."""
    lines = sass.splitlines()
    key = key or f"Function : _Z{len(kernel)}{kernel}"
    start = next(i for i, ln in enumerate(lines)
                 if "Function : " in ln and key in ln)
    end = next((i for i in range(start + 1, len(lines))
                if "Function : " in lines[i]), len(lines))
    ins = []
    for ln in lines[start:end]:
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z0-9_.]+)(.*);", ln)
        if m:
            ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    at = {a: k for k, (a, _, _) in enumerate(ins)}
    best = None
    for k, (a, op, rest) in enumerate(ins):
        t = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and t and int(t.group(1), 16) < a:
            b = at.get(int(t.group(1), 16))
            if b is not None and (best is None or k - b > best[1] - best[0]):
                best = (b, k)
    if best is None:
        return {}
    mix = collections.Counter(op.split(".")[0]
                              for _, op, _ in ins[best[0]:best[1] + 1])
    return {"instructions": best[1] - best[0] + 1, **dict(mix.most_common())}


def _secp(torch, rec):
    """K11 and K12 of the checkout: held against their plain versions,
    then timed by raw launches.  Returns whether both held."""
    import random

    import numpy as np

    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.crypto import secp256k1 as sk
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import cuda_secp as cs
    from cometbft_tpu_torch.ops import device as devmod
    from cometbft_tpu_torch.ops import fe_secp as fs
    from cometbft_tpu_torch.ops import secp256k1 as sko

    lib = _build.load("secp256k1_kernels")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptr = devmod.ptr
    gtab, gcorr, _ = sko.g_tables_on(dev)

    def frozen(t):
        return fs.freeze(t.movedim(-2, 0)).movedim(0, -2)

    def tables(kx, ky):
        nk = kx.shape[-1]
        outs = [torch.empty(shape, dtype=torch.int32, device=dev) for shape in
                ((52, 3, 22, nk), (52, 16, 3, 22, nk), (3, 22, nk))]
        return outs, (ptr(kx), ptr(ky), nk, *map(ptr, outs), stream)

    rng = random.Random(20261018)
    keys = {}
    for nk in SECP_KEYS:
        pts = [sk._jaffine(sk._jmul(rng.randrange(1, sk.N), sk._G))
               for _ in range(nk)]
        keys[nk] = tuple(torch.from_numpy(np.ascontiguousarray(np.stack(
            [fs.int_to_limbs(p[c]) for p in pts], 1))).to(dev)
            for c in (0, 1))
    (_, qt, qc), a = tables(*keys[4])
    ok = lib.secp_q_tables(*a) == 0
    pt, pc = sko.q_msm_tables_kernel_plain(*keys[4])
    k11_err = int((frozen(qt) != frozen(pt)).sum()
                  + (frozen(qc) != frozen(pc)).sum())
    privs = [sk.PrivKey.generate(bytes([i + 1]) * 32) for i in range(4)]
    pubs, msgs, sigs = [], [], []
    for i in range(96):
        m = b"time_kernels %d" % i
        sig = privs[i % 4].sign(m)
        if i % 3 == 1:
            sig = sig[:32] + ((int.from_bytes(sig[32:], "big") + 1) % sk.N
                              ).to_bytes(32, "big")
        pubs.append(privs[i % 4].pub_key().bytes())
        msgs.append(m)
        sigs.append(sig)
    pk = sk.pack_msm_batch(pubs, msgs, sigs, 256)
    args = cs.q_msm_tables(*(convert.to_device_async(pk[k], np.int32, dev)
                             for k in ("keys_x", "keys_y"))) \
        + convert.secp_msm_from_numpy(pk, dev)
    out = torch.empty((256,), dtype=torch.bool, device=dev)
    ok = ok and lib.secp_msm_verify(*map(ptr, (*args, gtab, gcorr)), 256,
                                    args[0].shape[-1], ptr(out), stream) == 0
    plain = sko.msm_verify_kernel_plain(*args)
    want = [sk.PubKey(p).verify_signature(m, g)
            for p, m, g in zip(pubs, msgs, sigs)]
    k12_ok = (bool((out == plain).all())
              and (out.cpu().numpy() & pk["valid"])[:96].tolist() == want
              and sum(want) == 64)
    rec.update(k11_err_k4=k11_err, k12_verdicts_equal=k12_ok,
               k11_ms={}, k12_ms={})
    has_steps = hasattr(lib, "secp_q_tables_walk")
    for nk in SECP_KEYS:
        (bases, qt, qc), a = tables(*keys[nk])
        ent = {"all": _time(torch, lib.secp_q_tables, a, inner=5)}
        if has_steps:
            ent["walk"] = _time(torch, lib.secp_q_tables_walk,
                                a[:4] + a[5:], inner=5)
            ent["rows"] = _time(torch, lib.secp_q_tables_rows,
                                (a[3], nk, a[4], stream), inner=5)
        rec["k11_ms"][nk] = ent
    gen = torch.Generator(device="cuda").manual_seed(20261018)
    for nb, nk in SECP_SHAPES:
        (_, qt, qc), a = tables(*keys[nk])
        lib.secp_q_tables(*a)

        def ri(hi, shape):
            return torch.randint(0, hi, shape, dtype=torch.int32,
                                 device="cuda", generator=gen)
        k12 = (qt, qc, ri(nk, (nb,)), ri(128, (32, nb)),
               ri(2, (32, nb)).bool(), ri(16, (52, nb)),
               ri(2, (52, nb)).bool(), ri(4096, (22, nb)),
               ri(4096, (22, nb)), ri(2, (nb,)).bool(), args[-1], gtab,
               gcorr)
        out = torch.empty((nb,), dtype=torch.bool, device="cuda")
        rec["k12_ms"][f"{nb}x{nk}"] = _time(
            torch, lib.secp_msm_verify,
            (*map(ptr, k12), nb, nk, ptr(out), stream))
    return ok and k11_err == 0 and k12_ok


def _ladder_tile(nb, rng):
    """K13 inputs of nb lanes (numpy, the JAX layout) and their verdicts:
    64 lanes from the host's group law, tiled to the width."""
    import numpy as np

    from cometbft_tpu_torch.crypto import secp256k1 as sk
    from cometbft_tpu_torch.ops import fe_secp as fs

    keys = [sk._jaffine(sk._jmul(rng.randrange(1, sk.N), sk._G))
            for _ in range(4)]
    cols, want = [], []
    for j in range(64):
        q, u1, u2 = keys[j % 4], rng.randrange(1, sk.N), rng.randrange(1, sk.N)
        x = sk._jaffine(sk._jadd(sk._jmul(u1, sk._G),
                                 sk._jmul(u2, q + (1,))))[0]
        r = x % sk.N + (1 if j % 3 == 1 else 0)
        nibs = [[(u >> (4 * (63 - w))) & 0xF for w in range(64)]
                for u in (u1, u2)]
        cols.append((fs.int_to_limbs(q[0]), fs.int_to_limbs(q[1]), *nibs,
                     fs.int_to_limbs(r), fs.int_to_limbs(r + sk.N),
                     r + sk.N < sk.P))
        want.append(j % 3 != 1)
    reps = -(-nb // 64)
    arrs = [np.tile(np.stack([c[k] for c in cols], -1), reps)[..., :nb]
            for k in range(7)]
    return [np.ascontiguousarray(a.astype(np.int32 if k < 6 else bool))
            for k, a in enumerate(arrs)], (want * reps)[:nb]


def _ladder(torch, rec):
    """K13 of the checkout: held against its plain version and the lanes'
    verdicts at each shape, then timed by raw launches.  Returns whether
    every shape held."""
    import importlib.util
    import random

    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import device as devmod
    from cometbft_tpu_torch.ops import secp256k1 as sko

    lib = _build.load("secp256k1_kernels")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    gtab = sko.g_tables_on(dev)[2]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[2] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = random.Random(20261018)
    ok = True
    rec.update(k13_verdicts_equal={}, k13_ms={})
    for nb in LADDER_SHAPES:
        if nb == 16:
            args, want = smoke._ladder_edges(torch)
        else:
            arrs, want = _ladder_tile(nb, rng)
            args = convert.secp_batch_from_numpy(arrs, dev)
        out = torch.empty((nb,), dtype=torch.bool, device=dev)
        call = (*map(devmod.ptr, (*args, gtab)), nb, devmod.ptr(out), stream)
        held = lib.secp_ladder(*call) == 0
        plain = sko.verify_kernel_plain(*args)
        held = (held and bool((out == plain).all())
                and all(w is None or w == v
                        for w, v in zip(want, out.cpu().tolist())))
        rec["k13_verdicts_equal"][nb] = held
        rec["k13_ms"][nb] = _time(torch, lib.secp_ladder, call, inner=10)
        ok = ok and held
    return ok


def _persig(torch, rec):
    """K14 of the checkout: held against its plain version and the lanes'
    verdicts at each shape, then timed by raw launches into a
    preallocated verdict.  Either C interface: with the -A tables in a
    scratch the caller allocates (before K14 ran on the native field,
    its tables in shared memory), or without.  Returns whether every
    shape held (True where the checkout has no K14: "absent")."""
    from cometbft_tpu_torch.ops import _build

    if "ed25519_persig" not in _build.SIGNATURES:
        rec["k14_ms"] = "absent"
        return True
    import random

    import numpy as np

    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.crypto import ed25519 as ted
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.ops import cuda_decompress as cd
    from cometbft_tpu_torch.ops import cuda_persig as cp
    from cometbft_tpu_torch.ops import device as devmod

    rng = random.Random(20261019)
    pubs, msgs, sigs = [], [], []
    for j in range(64):
        seed, msg = rng.randbytes(32), rng.randbytes(60)
        sig = ref.sign(seed, msg)
        if j % 3 == 1:
            s = (int.from_bytes(sig[32:], "little") + 1) % ref.L
            sig = sig[:32] + s.to_bytes(32, "little")
        pubs.append(ref.pubkey_from_seed(seed))
        msgs.append(msg)
        sigs.append(sig)
    packed = ted.pack_batch(pubs, msgs, sigs, 64)[:4]
    want = [j % 3 != 1 for j in range(64)]
    lib = cp._lib()
    scratch_arg = (_build.SIGNATURES["ed25519_persig"]
                   ["ed25519_verify_ladder"][5] is ctypes.c_void_p)
    dev = torch.device("cuda")
    btab = devmod.constant(cp._ed()._BTAB_NP, dev, torch.int32)
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    rec.update(k14_verdicts_equal={}, k14_ms={})
    for nb in PERSIG_SHAPES:
        reps = -(-nb // 64)
        aw, rw, st, ht = convert.batch_from_numpy(
            *(np.ascontiguousarray(np.tile(x, reps)[:, :nb]) for x in packed),
            dev)
        pts, oks = cd.decompress(torch.cat([aw, rw], dim=-1))
        out = torch.empty((nb,), dtype=torch.bool, device=dev)
        ins = [pts, oks, st, ht, btab]
        if scratch_arg:
            slots = -(-nb // 16) * 16
            ins.append(torch.empty((slots, 16, 4, 20), dtype=torch.int32,
                                   device=dev))
        call = (*map(devmod.ptr, ins), nb, devmod.ptr(out), None, stream)
        held = lib.ed25519_verify_ladder(*call) == 0
        plain = cp.verify_ladder_plain(pts, oks, st, ht)
        held = (held and bool((out == plain).all())
                and out.cpu().tolist() == (want * reps)[:nb])
        rec["k14_verdicts_equal"][nb] = held
        rec["k14_ms"][nb] = _time(torch, lib.ed25519_verify_ladder, call,
                                  inner=10)
        ok = ok and held
    return ok


def _sha_msgs(rng, n, lo, hi):
    """n messages of seeded lengths in [lo, hi] and seeded bytes."""
    lens = rng.integers(lo, hi + 1, n)
    return [rng.bytes(int(k)) for k in lens]


def _sha(torch, rec):
    """K9 and K10 of the checkout: each shape held word for word against
    its plain version and against hashlib, then timed by raw launches of
    its C function into preallocated outputs.  Returns whether every
    shape held."""
    import hashlib

    import numpy as np

    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import device as devmod
    from cometbft_tpu_torch.ops import sha2

    lib = _build.load("sha2_kernels")
    log = _build.build_info.get("sha2_kernels", {}).get("log", "")
    rec["sha_ptxas"] = [ln.strip() for ln in log.splitlines()
                        if any(k in ln for k in ("Compiling entry", "Used",
                                                 "stack frame"))]
    rng = np.random.default_rng(20261018)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    cases = [("sha512_blocks", n, 3, _sha_msgs(rng, n, 240, 367))
             for n in SHA512_SHAPES]
    cases += [("sha256_blocks", n, nblk,
               _sha_msgs(rng, n, 0, 55 if nblk == 1 else 119))
              for n, nblk in SHA256_SHAPES]
    ok = True
    rec.update(sha_equal={}, k9_ms={}, k10_ms={})
    for name, n, nblk, msgs in cases:
        if name == "sha512_blocks":
            *blocks, nb = sha2.pad_sha512(msgs, nblk)
            lib_hash, key, into = hashlib.sha512, str(n), rec["k9_ms"]
        else:
            *blocks, nb = sha2.pad_sha256(msgs, nblk)
            lib_hash, key, into = hashlib.sha256, f"{n}xB{nblk}", \
                rec["k10_ms"]
        args = [convert.words_from_numpy(b, dev) for b in blocks]
        args.append(torch.from_numpy(nb).to(dev))
        outs = [torch.empty((n, 8), dtype=torch.int32, device=dev)
                for _ in blocks]
        call = (*map(devmod.ptr, args), n, nblk, *map(devmod.ptr, outs),
                stream)
        fn = getattr(lib, name)
        held = fn(*call) == 0
        plain = getattr(sha2, name + "_plain")(*args)
        plain = plain if isinstance(plain, tuple) else (plain,)
        held = held and all(bool((o == p).all()) for o, p in zip(outs, plain))
        rows = [o.cpu().numpy() for o in outs]
        digest = (sha2.digest512_to_bytes if name == "sha512_blocks"
                  else sha2.digest256_to_bytes)
        held = held and all(digest(*(r[i] for r in rows)) ==
                            lib_hash(m).digest() for i, m in enumerate(msgs))
        rec["sha_equal"][f"{name} {key}"] = held
        into[key] = _time(torch, fn, call)
        ok = ok and held
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--k14", action="store_true",
                    help="time K14 alone")
    ap.add_argument("--sha", action="store_true",
                    help="time K9 and K10 alone")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import cuda_decompress as cd
    from cometbft_tpu_torch.ops import cuda_msm as cm
    from cometbft_tpu_torch.ops import device as devmod
    from cometbft_tpu_torch.ops import ed25519 as dev

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if args.k14 or args.sha:
        rec = {"card": card, "root": str(root)}
        ok = (_persig if args.k14 else _sha)(torch, rec)
        print(json.dumps(rec), flush=True)
        return 0 if ok else 1
    gen = torch.Generator(device="cuda").manual_seed(20261017)

    def words(w):
        return torch.randint(-2**31, 2**31 - 1, (8, w), dtype=torch.int32,
                             device="cuda", generator=gen)

    w129 = words(129)
    pk, okk = cd.decompress(w129)
    pp, okp = cd.decompress_plain(w129)
    k1_err = int((pk - pp).abs().max()) + int((okk != okp).sum())
    tab129 = cm.table17_neg(pp)
    k2_err = int((tab129 - cm.table17_neg_plain(pp)).abs().max())
    # ten decoded points and their negations: together they sum to the
    # identity
    pts = pp[..., okp.nonzero()[:10, 0]]
    neg = dev.point_neg(pts)
    k4_ok = (bool(cm.fold_verify(pts, neg))
             and bool(cm.fold_verify_plain(pts, neg)))
    m4 = torch.randint(0, 17, (4, 129), dtype=torch.int32, device="cuda",
                       generator=gen)
    n4 = torch.randint(0, 2, (4, 129), device="cuda", generator=gen) != 0
    k5_err = int((cm.msm_window_major_grouped(tab129, m4, n4, 2)
                  - cm.msm_window_major_grouped_plain(tab129, m4, n4, 2))
                 .abs().max())
    w1100 = words(1100)
    tab1100 = cm.table17_neg(cd.decompress_plain(w1100)[0])
    m6 = torch.randint(0, 17, (4, 1100), dtype=torch.int32, device="cuda",
                       generator=gen)
    n6 = torch.randint(0, 2, (4, 1100), device="cuda", generator=gen) != 0
    loop_err = {}
    for blk in LOOP_BLKS:
        if _loop_refused(cm, 1100, blk):
            loop_err[blk] = "refused"
            continue
        e6 = (cm.msm_window_loop(tab1100, m6, n6, blk)
              - cm.msm_window_loop_plain(tab1100, m6, n6, blk)).abs().max()
        e7 = (cm.select_tree(tab1100, m6[1], n6[1], blk)
              - cm.select_tree_plain(tab1100, m6[1], n6[1], blk)).abs().max()
        loop_err[blk] = int(e6) + int(e7)
    rec = {"card": card, "root": str(root), "k1_err_w129": k1_err,
           "k2_err_w129": k2_err, "k4_verdicts_equal": k4_ok,
           "k5_err_4x129": k5_err, "k6_k7_err_4x1100": loop_err,
           "k1_ms": {}, "k2_ms": {}, "k3_ms": {}, "k4_ms": {}, "k5_ms": {},
           "k6_ms": {}, "k7_ms": {}}
    lib = _build.load("ed25519_kernels")
    eng = _build.load("ed25519_engines")
    k5_group_arg = (_build.SIGNATURES["ed25519_engines"]
                    ["ed25519_msm_window_major_grouped"][5] is ctypes.c_int)
    k6_sums_arg = len(_build.SIGNATURES["ed25519_engines"]
                      ["ed25519_msm_window_loop"]) == 11
    stream = devmod.stream(w129)
    verdict = torch.empty((1,), dtype=torch.int32, device="cuda")
    for na, nr in K4_SHAPES:
        pa, pr = pts[..., :na].contiguous(), neg[..., :nr].contiguous()
        rec["k4_ms"][f"{na}+{nr}"] = _time(
            torch, lib.ed25519_fold_verify,
            (devmod.ptr(pa), na, devmod.ptr(pr), nr, devmod.ptr(verdict),
             stream))
    for w in WIDTHS:
        wd = words(w)
        pt = torch.empty((4, 20, w), dtype=torch.int32, device="cuda")
        ok = torch.empty((w,), dtype=torch.int32, device="cuda")
        tab = torch.empty((17, 4, 20, w), dtype=torch.int32, device="cuda")
        k1 = (devmod.ptr(wd), w, devmod.ptr(pt), devmod.ptr(ok), stream)
        k2 = (devmod.ptr(pt), w, devmod.ptr(tab), stream)
        rec["k1_ms"][w] = _time(torch, lib.ed25519_decompress, k1)
        rec["k2_ms"][w] = _time(torch, lib.ed25519_table17_neg, k2)
        nwin = 52 if w in (128, 10240) else 26
        mags = torch.randint(0, 17, (nwin, w), dtype=torch.int32,
                             device="cuda", generator=gen)
        negs = torch.randint(0, 2, (nwin, w), device="cuda",
                             generator=gen) != 0
        rec["k3_ms"][f"{nwin}x{w}"] = _time(
            torch, lambda: cm.msm_window_major(tab, mags, negs, group=1), ())
        nblk = -(-w // cm.GROUP_LANES)
        sums = torch.empty((nwin, 4, 20, nblk), dtype=torch.int32,
                           device="cuda")
        out = torch.empty((4, 20, nblk), dtype=torch.int32, device="cuda")
        negs8 = negs.view(torch.uint8)
        for requested in (4, 13):
            g = cm.group_for(nwin, requested)
            middle = (g,) if k5_group_arg else (devmod.ptr(sums),)
            rec["k5_ms"][f"{nwin}x{w} G{g}"] = _time(
                torch, eng.ed25519_msm_window_major_grouped,
                (devmod.ptr(tab), devmod.ptr(mags), devmod.ptr(negs8), w,
                 nwin, *middle, devmod.ptr(out), stream))
        mag0, neg0 = mags[0].contiguous(), negs8[0].contiguous()
        saved_blk = cm.BLK
        for requested in LOOP_BLKS:
            cm.BLK = requested
            blk = cm.loop_blk(w)
            key = f"{nwin}x{w} BLK{requested} blk{blk}"
            if _loop_refused(cm, w, blk):
                rec["k6_ms"][key] = rec["k7_ms"][key] = "refused"
                continue
            _, out_l, nblk = cm.loop_geometry(w, blk)
            nout = nblk * out_l
            lsums = torch.empty((nwin, 4, 20, nout), dtype=torch.int32,
                                device="cuda")
            lout = torch.empty((4, 20, nout), dtype=torch.int32,
                               device="cuda")
            middle = (devmod.ptr(lsums),) if k6_sums_arg else ()
            rec["k6_ms"][key] = _time(
                torch, eng.ed25519_msm_window_loop,
                (devmod.ptr(tab), devmod.ptr(mags), devmod.ptr(negs8), w,
                 nwin, blk, out_l, nout, *middle, devmod.ptr(lout), stream))
            rec["k7_ms"][key] = _time(
                torch, eng.ed25519_select_tree,
                (devmod.ptr(tab), devmod.ptr(mag0), devmod.ptr(neg0), w, blk,
                 out_l, nout, devmod.ptr(lout), stream))
        cm.BLK = saved_blk
    secp_ok = _secp(torch, rec) and _ladder(torch, rec)
    persig_ok = _persig(torch, rec)
    if args.sass:
        so = _build._target("ed25519_kernels")
        tool = Path(_build.nvcc()).parent / "cuobjdump"
        sass = subprocess.run([str(tool), "-sass", str(so)],
                              capture_output=True, text=True).stdout
        rec["loop_mix"] = {k: _loop_mix(sass, k) for k in
                           ("decompress_kernel", "table17_neg_kernel")}
    print(json.dumps(rec), flush=True)
    loop_ok = all(e in (0, "refused") for e in loop_err.values())
    return 0 if (k1_err == 0 and k2_err == 0 and k4_ok and k5_err == 0
                 and loop_ok and secp_ok and persig_ok) else 1


if __name__ == "__main__":
    sys.exit(main())
