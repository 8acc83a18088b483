#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's Ed25519 commit-verification path on one
NVIDIA card and hold each of its CUDA kernels against its plain torch
version.

    python3 chip_smoke.py

Phases (one JSON line each; any failure exits non-zero and prints no
result):
  1. build   compile ops/csrc/*.cu with nvcc (one nvcc per source, in
             parallel) and print the card's name and power limit;
  2. commit  one 150-validator commit through verify_commit_light on the
             card: accept, one tampered signature (ErrInvalidSignature
             naming its index), a commit below +2/3;
  3. window  a blocksync window — 48 heights x 150 validators collected
             with DeferredSigBatch — three times with one validator set
             (whole program, then the cached-A program once the
             ATableCache holds the set's tables), then a window with one
             bad signature at a known height;
  4. batch   8,192 signatures under distinct keys through
             create_batch_verifier("ed25519", device="cuda"): clean, then
             with an s >= L signature, non-canonical-y keys and a tampered
             signature, every verdict held against the pure-Python
             ed25519_ref.verify;
  5. kernels each kernel vs its plain version on the card, at the shapes
             phases 3-4 gave it (exact integer equality);
  6. timing  each kernel's and plain version's median time (CUDA events),
             with the bound the card could reach for the same work.
The launch counters are reset before phase 2 and read after phase 4:
every kernel must have launched on the main path.  Keys and messages
come from a fixed seed; the RLC weights are drawn from `secrets`, as
they are in use.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20261016
CHAIN_ID = "chip-smoke-chain"
N_VALS = 150
WINDOW = 48                    # blocksync VERIFY_WINDOW
N_BATCH = 8192
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT32_LANES_PER_SM_CLK = 64    # Hopper white paper
SOURCE = "cometbft_tpu_torch/ops/csrc/ed25519_kernels.cu"

# field products per kernel step, as int32 multiply-adds (mul 400,
# squaring 210); used for the operation bound
MUL, SQR = 400, 210
DBL_T, DBL = 4 * MUL + 4 * SQR, 3 * MUL + 4 * SQR
ADD = MUL + 8 * MUL                  # to_cached + add_cached
DECOMPRESS = 255 * SQR + 19 * MUL    # y^2, v^2, v3^2, 251 in pow_p58, r^2
TABLE = MUL + 15 * 8 * MUL


# -- host fixtures (pure Python, several processes) --------------------------

def _pubkeys(seeds):
    sys.path.insert(0, str(ROOT))
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    return [ref.pubkey_from_seed(s) for s in seeds]


def _sign(jobs):
    sys.path.insert(0, str(ROOT))
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    return [ref.sign(seed, msg) for seed, msg in jobs]


def _verify(jobs):
    sys.path.insert(0, str(ROOT))
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    return [ref.verify(pk, msg, sig) for pk, msg, sig in jobs]


def _chunks(xs, n):
    k = max(1, -(-len(xs) // n))
    return [xs[i:i + k] for i in range(0, len(xs), k)]


def _pool_map(pool, fn, items):
    out = []
    for part in pool.map(fn, _chunks(items, 4 * (os.cpu_count() or 1))):
        out.extend(part)
    return out


def _seed(*parts) -> bytes:
    return hashlib.sha256(repr((SEED,) + parts).encode()).digest()


# -- output -------------------------------------------------------------------

def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(Exception):
    pass


def check(cond, msg) -> None:
    if not cond:
        raise PhaseError(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "cometbft_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: the cometbft_tpu_torch package is not next to "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import multiprocessing as mp

    torch.cuda.set_device(0)
    state = {}
    phases = [phase_build, phase_fixtures, phase_commit, phase_window,
              phase_batch, phase_kernels, phase_timing]
    ctx = mp.get_context("spawn")
    with ctx.Pool(os.cpu_count() or 1) as pool:
        state["pool"] = pool
        for ph in phases:
            name = ph.__name__[len("phase_"):]
            t0 = time.perf_counter()
            try:
                rec = ph(state, torch) or {}
            except Exception as e:                      # noqa: BLE001
                traceback.print_exc()
                emit({"phase": name, "ok": False,
                      "error": f"{type(e).__name__}: {e}"})
                return 1
            emit({"phase": name, "ok": True,
                  "seconds": time.perf_counter() - t0, **rec})
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    emit({"kernels": state["kernel_rows"]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# -- phase 1 -----------------------------------------------------------------

def phase_build(state, torch):
    from cometbft_tpu_torch.ops import _build

    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    _build.build(sources)
    for name in sources:
        _build.load(name)
    ptxas = [ln.strip() for name in sources
             for ln in _build.build_info[name]["log"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    clock = nvidia_smi("clocks.max.sm").split()[0]
    state["sm_clock_hz"] = float(clock) * 1e6
    state["card"] = card
    return {"card": card, "build_seconds": time.perf_counter() - t0,
            "sources": sources, "max_sm_clock_mhz": float(clock),
            "ptxas": ptxas}


# -- fixtures ------------------------------------------------------------------

def phase_fixtures(state, torch):
    """Keys and signatures for phases 2-4, signed in several processes;
    the seconds spent here are reported apart from every verify rate."""
    import numpy as np
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.types import block, canonical
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet

    pool = state["pool"]
    t0 = time.perf_counter()
    val_seeds = [_seed("validator", i) for i in range(N_VALS)]
    val_pubs = _pool_map(pool, _pubkeys, val_seeds)
    vals = ValidatorSet([Validator(ed.PubKey(p), 10) for p in val_pubs])
    seed_of = {ed.PubKey(p).address(): s
               for p, s in zip(val_pubs, val_seeds)}

    def commit_jobs(height):
        bid = block.BlockID(_seed("block", height), block.PartSetHeader(
            1, _seed("parts", height)))
        rows = []
        for i, v in enumerate(vals.validators):
            ts = Timestamp(1_700_000_000 + height, 1000 * i + 7)
            sb = canonical.vote_sign_bytes(CHAIN_ID, canonical.PRECOMMIT,
                                           height, 0, bid, ts)
            rows.append((v.address, ts, seed_of[v.address], sb))
        return bid, rows

    heights = [1000 + h for h in range(WINDOW)] + [5]
    built = {h: commit_jobs(h) for h in heights}
    jobs = [(seed, sb) for h in heights for (_, _, seed, sb) in built[h][1]]
    sigs = iter(_pool_map(pool, _sign, jobs))
    commits = {}
    for h in heights:
        bid, rows = built[h]
        cs = [block.CommitSig(block.BLOCK_ID_FLAG_COMMIT, addr, ts, next(sigs))
              for addr, ts, _, _ in rows]
        commits[h] = (bid, block.Commit(h, 0, bid, cs))

    rng = np.random.default_rng(SEED)
    b_seeds = [_seed("batch", i) for i in range(N_BATCH)]
    b_msgs = [rng.bytes(110) for _ in range(N_BATCH)]
    b_pubs = _pool_map(pool, _pubkeys, b_seeds)
    b_sigs = _pool_map(pool, _sign, list(zip(b_seeds, b_msgs)))
    sign_s = time.perf_counter() - t0
    state.update(vals=vals, commits=commits, heights=heights[:WINDOW],
                 batch=(b_pubs, b_msgs, b_sigs), ref=ref)
    return {"validators": N_VALS, "commits": len(commits),
            "commit_signatures": len(jobs), "batch_signatures": N_BATCH,
            "signing_seconds": sign_s}


# -- main path: launch accounting ---------------------------------------------

def _kernels():
    from cometbft_tpu_torch.ops import cuda_decompress, cuda_msm
    return {"ed25519_decompress": cuda_decompress.decompress,
            "ed25519_table17_neg": cuda_msm.table17_neg,
            "ed25519_msm_window_major": cuda_msm.msm_window_major,
            "ed25519_fold_verify": cuda_msm.fold_verify}


def _counts():
    return {k: fn.launches for k, fn in _kernels().items()}


class _Timed:
    """Wraps a module function to record its calls' wall seconds (each
    call ends in a host sync: a verdict read back)."""

    def __init__(self, mod, attr, torch):
        self.mod, self.attr, self.fn = mod, attr, getattr(mod, attr)
        self.torch, self.calls, self.seconds = torch, 0, 0.0

    def __enter__(self):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = self.fn(*a, **k)
            if DEVICE == "cuda":
                self.torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out
        setattr(self.mod, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.fn)


def phase_commit(state, torch):
    from cometbft_tpu_torch.types import validation as val

    for fn in _kernels().values():
        fn.launches = 0                 # main path starts here
    state["main_t0"] = time.perf_counter()
    vals = state["vals"]
    bid, commit = state["commits"][5]
    before = _counts()
    t0 = time.perf_counter()
    val.verify_commit_light(CHAIN_ID, vals, bid, 5, commit, device=DEVICE)
    accept_s = time.perf_counter() - t0

    bad_idx = N_VALS // 4
    sigs = list(commit.signatures)
    s = bytearray(sigs[bad_idx].signature)
    s[11] ^= 0x40
    sigs[bad_idx] = type(sigs[bad_idx])(sigs[bad_idx].block_id_flag,
                                        sigs[bad_idx].validator_address,
                                        sigs[bad_idx].timestamp, bytes(s))
    tampered = type(commit)(5, 0, bid, sigs)
    try:
        val.verify_commit_light(CHAIN_ID, vals, bid, 5, tampered,
                                device=DEVICE)
        raise PhaseError("tampered commit accepted")
    except val.ErrInvalidSignature as e:
        check(str(e).startswith(f"wrong signature (#{bad_idx}): "
                                f"{bytes(s).hex()}"), f"wrong message {e}")

    from cometbft_tpu_torch.types import block
    needed = 10 * N_VALS * 2 // 3
    few = [cs if i < needed // 10 else block.CommitSig.absent()
           for i, cs in enumerate(commit.signatures)]
    try:
        val.verify_commit_light(CHAIN_ID, vals, bid, 5,
                                type(commit)(5, 0, bid, few), device=DEVICE)
        raise PhaseError("commit below +2/3 accepted")
    except val.ErrNotEnoughVotingPowerSigned as e:
        check(str(e) == "invalid commit -- insufficient voting power: got "
              f"{needed // 10 * 10}, needed more than {needed}",
              f"wrong message {e}")
    after = _counts()
    return {"accept_seconds": accept_s,
            "launches": {k: after[k] - before[k] for k in after}}


def _run_window(state, val, commits):
    batch = val.DeferredSigBatch()
    for h, (bid, commit) in commits:
        val.verify_commit_light(CHAIN_ID, state["vals"], bid, h, commit,
                                defer_to=batch, device=DEVICE)
    n = batch.count()
    batch.verify(device=DEVICE)
    return n


def phase_window(state, torch):
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.ops import ed25519 as dev
    from cometbft_tpu_torch.types import validation as val

    commits = [(h, state["commits"][h]) for h in state["heights"]]
    start = _counts()
    ed._A_TABLE_CACHE = ed.ATableCache()
    cache = ed._A_TABLE_CACHE
    runs = []
    for _ in range(3):
        before = _counts()
        hits, misses = cache.hits, cache.misses
        with _Timed(ed, "rlc_verify", torch) as rlc:
            t0 = time.perf_counter()
            n = _run_window(state, val, commits)
            wall = time.perf_counter() - t0
        after = _counts()
        program = "cached_a" if (cache.hits + cache.misses
                                 > hits + misses) else "whole"
        runs.append({"signatures": n, "seconds": wall,
                     "sigs_per_s": n / wall,
                     "rlc_verify_seconds": rlc.seconds,
                     "program": program,
                     "cache_hit": cache.hits > hits,
                     "launches": {k: after[k] - before[k] for k in after}})
    check([r["program"] for r in runs] == ["whole", "cached_a", "cached_a"],
          f"programs {[r['program'] for r in runs]}")
    check(runs[2]["cache_hit"], "third window missed the ATableCache")

    # one bad signature at a known height
    bad_h = state["heights"][len(state["heights"]) // 3]
    bid, commit = state["commits"][bad_h]
    sigs = list(commit.signatures)
    s = bytearray(sigs[5].signature)
    s[40] ^= 0x01
    sigs[5] = type(sigs[5])(sigs[5].block_id_flag, sigs[5].validator_address,
                            sigs[5].timestamp, bytes(s))
    bad = [(h, (b, type(c)(h, 0, b, sigs) if h == bad_h else c))
           for h, (b, c) in commits]
    with _Timed(dev, "verify_kernel", torch) as persig:
        t0 = time.perf_counter()
        try:
            _run_window(state, val, bad)
            raise PhaseError("bad window accepted")
        except val.ErrInvalidSignature as e:
            check(getattr(e, "failed_ctx", None) == bad_h,
                  f"blamed {getattr(e, 'failed_ctx', None)}, not {bad_h}")
            check(str(e) == f"wrong signature in commit at height {bad_h}: "
                  f"{bytes(s).hex()}", f"wrong message {e}")
        reject_s = time.perf_counter() - t0
    packed = ed.pack_rlc(*_window_items(state, bad))
    state["window_packed_bad"] = packed
    state["window_packed"] = ed.pack_rlc(*_window_items(state, commits))
    end = _counts()
    return {"runs": runs, "bad_height": bad_h, "reject_seconds": reject_s,
            "launches": {k: end[k] - start[k] for k in end},
            "persig_seconds": persig.seconds, "persig_calls": persig.calls}


def _window_items(state, commits):
    from cometbft_tpu_torch.types import validation as val

    batch = val.DeferredSigBatch()
    for h, (bid, commit) in commits:
        val.verify_commit_light(CHAIN_ID, state["vals"], bid, h, commit,
                                defer_to=batch, device=DEVICE)
    ents = batch._entries
    return ([e[2].bytes() for e in ents], [e[3] for e in ents],
            [e[4] for e in ents])


def phase_batch(state, torch):
    from cometbft_tpu_torch.crypto import batch as cb
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.ops import ed25519 as dev

    ref = state["ref"]
    before = _counts()
    pubs, msgs, sigs = (list(x) for x in state["batch"])
    bv = cb.create_batch_verifier("ed25519", n_hint=N_BATCH, device=DEVICE)
    for p, m, s in zip(pubs, msgs, sigs):
        bv.add(p, m, s)
    with _Timed(ed, "rlc_verify", torch) as rlc:
        t0 = time.perf_counter()
        ok, verdicts = bv.verify()
        clean_s = time.perf_counter() - t0
    check(ok and all(verdicts) and len(verdicts) == N_BATCH,
          "clean batch rejected")

    # hostile entries: s >= L, a key with y = p + 3 under a junk
    # signature, a tampered signature, and a VALID signature under the
    # non-canonical encoding y = p + 1 of the identity (R = sB)
    i1, i2, i3, i4 = (N_BATCH // 8 * k for k in (1, 2, 3, 4))
    sigs[i1] = sigs[i1][:32] + (ref.L + 7).to_bytes(32, "little")
    pubs[i2] = (ref.P + 3).to_bytes(32, "little")
    t = bytearray(sigs[i3])
    t[50] ^= 0x08
    sigs[i3] = bytes(t)
    k = 987654321
    pubs[i4] = (ref.P + 1).to_bytes(32, "little")
    sigs[i4] = ref.point_compress(ref.point_mul(k, ref.B)) + \
        k.to_bytes(32, "little")
    bv = cb.create_batch_verifier("ed25519", n_hint=N_BATCH, device=DEVICE)
    for p, m, s in zip(pubs, msgs, sigs):
        bv.add(p, m, s)
    with _Timed(dev, "verify_kernel", torch) as persig:
        t0 = time.perf_counter()
        ok, verdicts = bv.verify()
        hostile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = _pool_map(state["pool"], _verify, list(zip(pubs, msgs, sigs)))
    oracle_s = time.perf_counter() - t0
    check(verdicts == want, "verdicts differ from ed25519_ref.verify at "
          f"{[i for i, (a, b) in enumerate(zip(verdicts, want)) if a != b][:8]}")
    check(not ok and [i for i, v in enumerate(want) if not v]
          == [i1, i2, i3], "unexpected reject set")
    check(want[i4], "identity-key signature rejected")
    state["main_s"] = time.perf_counter() - state["main_t0"]
    state["main_launches"] = _counts()
    check(all(v > 0 for v in state["main_launches"].values()),
          f"a kernel never launched on the main path: "
          f"{state['main_launches']}")
    state["batch_items"] = (pubs, msgs, sigs)
    state["batch_packed"] = ed.pack_rlc(*state["batch"])
    return {"clean_seconds": clean_s, "clean_sigs_per_s": N_BATCH / clean_s,
            "clean_rlc_verify_seconds": rlc.seconds,
            "hostile_seconds": hostile_s, "persig_seconds": persig.seconds,
            "oracle_seconds": oracle_s,
            "launches": {k: state["main_launches"][k] - before[k]
                         for k in before},
            "main_path_launches": state["main_launches"]}


# -- phase 5: kernel vs plain --------------------------------------------------

def _hostile_words(state, torch):
    """K1 input at W = 8192: the phase-4 public keys (two of them
    non-canonical) with more hostile lanes: x = 0 with the sign bit,
    u/v not a square, an 8-torsion point, y = 2^255 - 1."""
    from cometbft_tpu_torch import convert
    import numpy as np

    ref = state["ref"]
    pubs = list(state["batch_items"][0])
    bad_y = [y for y in range(2, 64)
             if ref.point_decompress(y.to_bytes(32, "little")) is None]
    pubs[10] = (1 | (1 << 255)).to_bytes(32, "little")
    pubs[11] = bad_y[0].to_bytes(32, "little")
    pubs[12] = bytes.fromhex(
        "26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05")
    pubs[13] = ((1 << 255) - 1).to_bytes(32, "little")
    words = np.stack([np.frombuffer(p, dtype=np.uint32) for p in pubs], 1)
    return convert.words_from_numpy(words, DEVICE)


def _proj_err(torch, fe, a, b):
    """max |X1 Z2 - X2 Z1| and |Y1 Z2 - Y2 Z1| over frozen limbs."""
    def f(x):
        return fe.freeze(x)
    ex = (f(fe.mul(a[0], b[2])) - f(fe.mul(b[0], a[2]))).abs().max()
    ey = (f(fe.mul(a[1], b[2])) - f(fe.mul(b[1], a[2]))).abs().max()
    return int(max(ex, ey))


def phase_kernels(state, torch):
    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.ops import cuda_decompress as cd
    from cometbft_tpu_torch.ops import cuda_msm as cm
    from cometbft_tpu_torch.ops import fe

    saved = _counts()
    cases = {}
    words = _hostile_words(state, torch)
    pk, okk = cd.decompress(words)
    pp, okp = cd.decompress_plain(words)
    err = int((pk - pp).abs().max()) + int((okk != okp).sum())
    check(err == 0, f"K1 differs from plain by {err}")
    check(not bool(okk[10]) and not bool(okk[11]) and bool(okk[12]),
          "hostile lanes decoded wrongly")
    cases["ed25519_decompress"] = [{"shape": [8, words.shape[-1]],
                                    "max_abs_err": err,
                                    "args": (words,)}]

    shapes = {}
    for label, packed in (("window", state["window_packed"]),
                          ("batch", state["batch_packed"])):
        t = convert.packed_from_numpy(packed, DEVICE)
        shapes[label] = t
    k2, k3 = [], []
    for label, t in shapes.items():
        for side, (w, mags, negs) in (("A", (t[0], t[2], t[3])),
                                      ("R", (t[1], t[4], t[5]))):
            pt, _ = cd.decompress(w)
            tab = cm.table17_neg(pt)
            tab_p = cm.table17_neg_plain(pt)
            e2 = int((tab - tab_p).abs().max())
            check(e2 == 0, f"K2 {label}/{side} differs by {e2}")
            if side == "A":
                k2.append({"shape": [4, 20, pt.shape[-1]], "max_abs_err": e2,
                           "args": (pt,), "phase": label})
            part = cm.msm_window_major(tab, mags, negs)
            part_p = cm.msm_window_major_plain(tab, mags, negs)
            e3 = int((part - part_p).abs().max())
            e3 = max(e3, _proj_err(torch, fe, part, part_p))
            check(e3 == 0, f"K3 {label}/{side} differs by {e3}")
            k3.append({"shape": [int(mags.shape[0]), int(mags.shape[1])],
                       "max_abs_err": e3, "args": (tab, mags, negs),
                       "phase": label, "partials": part})
    cases["ed25519_table17_neg"] = k2
    cases["ed25519_msm_window_major"] = k3
    k4 = []
    bad = convert.packed_from_numpy(state["window_packed_bad"], DEVICE)
    bad_pa, bad_pr = (cm.msm_window_major(cm.table17_neg(cd.decompress(w)[0]),
                                          m, n)
                      for w, m, n in ((bad[0], bad[2], bad[3]),
                                      (bad[1], bad[4], bad[5])))
    for label, want, pa, pr in (
            ("batch accept", True, k3[2]["partials"], k3[3]["partials"]),
            ("window accept", True, k3[0]["partials"], k3[1]["partials"]),
            ("window reject", False, bad_pa, bad_pr)):
        got = cm.fold_verify(pa, pr)
        plain = cm.fold_verify_plain(pa, pr)
        check(bool(got) is want and bool(plain) is want,
              f"K4 {label}: kernel {bool(got)}, plain {bool(plain)}")
        k4.append({"shape": [int(pa.shape[-1]), int(pr.shape[-1])],
                   "max_abs_err": 0, "args": (pa, pr), "phase": label})
    cases["ed25519_fold_verify"] = k4
    for name, fn in _kernels().items():  # comparison launches do not count
        fn.launches = saved[name]
    state["cases"] = cases
    return {"tolerance": "exact: integer limbs, frozen and projective",
            "compared": {k: [dict(shape=c["shape"],
                                  max_abs_err=c["max_abs_err"],
                                  phase=c.get("phase", "batch"))
                             for c in v] for k, v in cases.items()}}


# -- phase 6: timing -------------------------------------------------------------

def _time(torch, fn, args, reps):
    fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _work(name, case):
    """(int32 multiply-adds, bytes) the function needs on these inputs:
    field products only; each input read once, each output written
    once."""
    if name == "ed25519_decompress":
        w = case["args"][0].shape[-1]
        return w * DECOMPRESS, w * (32 + 320 + 4)
    if name == "ed25519_table17_neg":
        w = case["args"][0].shape[-1]
        return w * TABLE, w * (320 + 17 * 320)
    if name == "ed25519_msm_window_major":
        tab, mags, _ = case["args"]
        nwin, w = mags.shape
        nblk = -(-w // 32)
        ops = nwin * (w - 1) * ADD + (nwin - 1) * (4 * DBL + DBL_T + ADD)
        return ops, w * 17 * 320 + nwin * w * 5 + nblk * 320
    pa, pr = case["args"]
    n = pa.shape[-1] + pr.shape[-1]
    return (n - 1) * ADD + 3 * DBL, n * 320 + 4


def phase_timing(state, torch):
    from cometbft_tpu_torch.ops import cuda_decompress as cd
    from cometbft_tpu_torch.ops import cuda_msm as cm

    plain = {"ed25519_decompress": cd.decompress_plain,
             "ed25519_table17_neg": cm.table17_neg_plain,
             "ed25519_msm_window_major": cm.msm_window_major_plain,
             "ed25519_fold_verify": cm.fold_verify_plain}
    saved = _counts()
    peak_ops = 132 * INT32_LANES_PER_SM_CLK * state["sm_clock_hz"]
    replaces = {
        "ed25519_decompress": "cometbft_tpu/ops/pallas_decompress.py:143",
        "ed25519_table17_neg": "cometbft_tpu/ops/pallas_msm.py:417",
        "ed25519_msm_window_major": "cometbft_tpu/ops/pallas_msm.py:498",
        "ed25519_fold_verify": "cometbft_tpu/ops/pallas_msm.py:730"}
    rows = []
    for name, fn in _kernels().items():
        shapes = []
        for case in state["cases"][name]:
            ms = _time(torch, fn, case["args"], 10)
            plain_ms = _time(torch, plain[name], case["args"], 3)
            ops, nbytes = _work(name, case)
            t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            shapes.append({"shape": case["shape"],
                           "phase": case.get("phase", "batch"), "ms": ms,
                           "plain_ms": plain_ms,
                           "bound_ms": max(t_ops, t_bytes),
                           "bound_by": "operations" if t_ops >= t_bytes
                           else "bytes", "int32_madds": ops, "bytes": nbytes,
                           "max_abs_err": case["max_abs_err"]})
        top = max(shapes, key=lambda s: s["ms"])
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": replaces[name],
                     "launches": state["main_launches"][name],
                     "max_abs_err": max(s["max_abs_err"] for s in shapes),
                     "ms": top["ms"], "plain_ms": top["plain_ms"],
                     "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                     "library_ms": None, "matches_plain": True,
                     "shape": top["shape"], "shapes": shapes})
    for name, fn in _kernels().items():   # timing launches do not count
        fn.launches = saved[name]
    state["kernel_rows"] = rows
    return {"card": state["card"], "peak_int32_madds_per_s": peak_ops,
            "main_path_seconds": state["main_s"]}


if __name__ == "__main__":
    sys.exit(main())
