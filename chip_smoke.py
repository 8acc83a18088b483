#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's Ed25519 commit-verification path on one
NVIDIA card, in each of its MSM engine configurations, and hold each of
its CUDA kernels against its plain torch version.

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
  5. engines the same entry points under each MSM engine configuration
             (the JAX package's flags, set on the port's modules):
             window_loop (K6), grouped_g4 and grouped_g13 (K5),
             select_tree (K7 in the window scan, no fold kernel) and
             fold_off (K3, no fold kernel) — the commit (accept and the
             tampered signature), the window (accept and the bad height),
             and for window_loop and grouped_g4 the clean 8,192 batch;
             each must launch exactly its configuration's kernels;
  6. kernels each kernel vs its plain version on the card, at the shapes
             phases 3-4 gave it (exact integer equality), K5 also vs K3,
             and K3, K5, K6, K7 on digits with magnitudes outside 0..16;
  7. timing  each kernel's and plain version's median time (CUDA events),
             with the bound the card could reach for the same work.
The launch counters are reset before phase 2 and read after phase 4
(the default engine: every one of K1-K4 must launch there, none of
K5-K7), and reset before and read after each configuration of phase 5.
Keys and messages come from a fixed seed; the RLC weights are drawn from
`secrets`, as they are in use.
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
CSRC = "cometbft_tpu_torch/ops/csrc/"

# kernel -> (source, the TPU kernel's pallas_call it replaces)
KERNELS = {
    "ed25519_decompress": ("ed25519_kernels.cu",
                           "cometbft_tpu/ops/pallas_decompress.py:143"),
    "ed25519_table17_neg": ("ed25519_kernels.cu",
                            "cometbft_tpu/ops/pallas_msm.py:417"),
    "ed25519_msm_window_major": ("ed25519_kernels.cu",
                                 "cometbft_tpu/ops/pallas_msm.py:498"),
    "ed25519_fold_verify": ("ed25519_kernels.cu",
                            "cometbft_tpu/ops/pallas_msm.py:730"),
    "ed25519_msm_window_major_grouped": ("ed25519_engines.cu",
                                         "cometbft_tpu/ops/pallas_msm.py:624"),
    "ed25519_msm_window_loop": ("ed25519_engines.cu",
                                "cometbft_tpu/ops/pallas_msm.py:317"),
    "ed25519_select_tree": ("ed25519_engines.cu",
                            "cometbft_tpu/ops/pallas_msm.py:360"),
}
DEFAULT_KERNELS = {"ed25519_decompress", "ed25519_table17_neg",
                   "ed25519_msm_window_major", "ed25519_fold_verify"}

# the engine flags (ops/ed25519 USE_PALLAS_*, ops/cuda_msm WIN_GROUP) at
# the JAX package's defaults, and each configuration of phase 5: its
# flags, the kernels it must launch (and no other), whether it also runs
# the 8,192 batch
DEFAULT_ENGINE = {"USE_PALLAS_MSM_MAJOR": True, "USE_PALLAS_MSM_LOOP": True,
                  "USE_PALLAS_TREE": False, "USE_PALLAS_FOLD": True,
                  "WIN_GROUP": 1}
_TABLES = {"ed25519_decompress", "ed25519_table17_neg"}
ENGINES = [
    ("window_loop", {"USE_PALLAS_MSM_MAJOR": False},
     _TABLES | {"ed25519_msm_window_loop", "ed25519_fold_verify"}, True),
    ("grouped_g4", {"WIN_GROUP": 4},
     _TABLES | {"ed25519_msm_window_major_grouped", "ed25519_fold_verify"},
     True),
    ("grouped_g13", {"WIN_GROUP": 13},
     _TABLES | {"ed25519_msm_window_major_grouped", "ed25519_fold_verify"},
     False),
    ("select_tree", {"USE_PALLAS_MSM_MAJOR": False,
                     "USE_PALLAS_MSM_LOOP": False, "USE_PALLAS_TREE": True},
     _TABLES | {"ed25519_select_tree"}, False),
    ("fold_off", {"USE_PALLAS_FOLD": False},
     _TABLES | {"ed25519_msm_window_major"}, False),
]

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
              phase_batch, phase_engines, phase_kernels, phase_timing]
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
            "ed25519_fold_verify": cuda_msm.fold_verify,
            "ed25519_msm_window_major_grouped":
                cuda_msm.msm_window_major_grouped,
            "ed25519_msm_window_loop": cuda_msm.msm_window_loop,
            "ed25519_select_tree": cuda_msm.select_tree}


def _counts():
    return {k: fn.launches for k, fn in _kernels().items()}


def _zero_counts():
    for fn in _kernels().values():
        fn.launches = 0


def _set_engine(flags):
    """Set the port's engine flags: DEFAULT_ENGINE updated by flags."""
    from cometbft_tpu_torch.ops import cuda_msm
    from cometbft_tpu_torch.ops import ed25519 as dev

    for name, value in {**DEFAULT_ENGINE, **flags}.items():
        setattr(cuda_msm if name == "WIN_GROUP" else dev, name, value)


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


def _with_sig(commit, idx, byte, bit):
    """commit with signature idx's byte flipped at bit: (commit, sig)."""
    sigs = list(commit.signatures)
    s = bytearray(sigs[idx].signature)
    s[byte] ^= bit
    sigs[idx] = type(sigs[idx])(sigs[idx].block_id_flag,
                                sigs[idx].validator_address,
                                sigs[idx].timestamp, bytes(s))
    return type(commit)(commit.height, commit.round, commit.block_id,
                        sigs), bytes(s)


def _commit_accept_reject(state, val):
    """The 150-validator commit: accept, then one tampered signature
    whose error names its index.  (accept seconds, reject seconds)."""
    vals = state["vals"]
    bid, commit = state["commits"][5]
    t0 = time.perf_counter()
    val.verify_commit_light(CHAIN_ID, vals, bid, 5, commit, device=DEVICE)
    accept_s = time.perf_counter() - t0
    bad_idx = N_VALS // 4
    tampered, s = _with_sig(commit, bad_idx, 11, 0x40)
    t0 = time.perf_counter()
    try:
        val.verify_commit_light(CHAIN_ID, vals, bid, 5, tampered,
                                device=DEVICE)
        raise PhaseError("tampered commit accepted")
    except val.ErrInvalidSignature as e:
        check(str(e).startswith(f"wrong signature (#{bad_idx}): "
                                f"{s.hex()}"), f"wrong message {e}")
    return accept_s, time.perf_counter() - t0


def phase_commit(state, torch):
    from cometbft_tpu_torch.types import validation as val

    _set_engine({})
    _zero_counts()                      # main path starts here
    state["main_t0"] = time.perf_counter()
    vals = state["vals"]
    bid, commit = state["commits"][5]
    before = _counts()
    accept_s, _ = _commit_accept_reject(state, val)

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


def _window_reject(state, val, commits):
    """The window with one bad signature at a known height: the error
    must name the height.  (seconds, the bad window's commits)."""
    bad_h = state["heights"][len(state["heights"]) // 3]
    bid, commit = state["commits"][bad_h]
    bad_commit, s = _with_sig(commit, 5, 40, 0x01)
    bad = [(h, (b, bad_commit if h == bad_h else c))
           for h, (b, c) in commits]
    t0 = time.perf_counter()
    try:
        _run_window(state, val, bad)
        raise PhaseError("bad window accepted")
    except val.ErrInvalidSignature as e:
        check(getattr(e, "failed_ctx", None) == bad_h,
              f"blamed {getattr(e, 'failed_ctx', None)}, not {bad_h}")
        check(str(e) == f"wrong signature in commit at height {bad_h}: "
              f"{s.hex()}", f"wrong message {e}")
    return time.perf_counter() - t0, bad, bad_h


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

    with _Timed(dev, "verify_kernel", torch) as persig:
        reject_s, bad, bad_h = _window_reject(state, val, commits)
    state["window_packed_bad"] = ed.pack_rlc(*_window_items(state, bad))
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


def _clean_batch(state, torch):
    """The 8,192 distinct-key batch, clean: (seconds, rlc seconds)."""
    from cometbft_tpu_torch.crypto import batch as cb
    from cometbft_tpu_torch.crypto import ed25519 as ed

    bv = cb.create_batch_verifier("ed25519", n_hint=N_BATCH, device=DEVICE)
    for p, m, s in zip(*state["batch"]):
        bv.add(p, m, s)
    with _Timed(ed, "rlc_verify", torch) as rlc:
        t0 = time.perf_counter()
        ok, verdicts = bv.verify()
        seconds = time.perf_counter() - t0
    check(ok and all(verdicts) and len(verdicts) == N_BATCH,
          "clean batch rejected")
    return seconds, rlc.seconds


def phase_batch(state, torch):
    from cometbft_tpu_torch.crypto import batch as cb
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.ops import ed25519 as dev

    ref = state["ref"]
    before = _counts()
    clean_s, clean_rlc_s = _clean_batch(state, torch)

    # hostile entries: s >= L, a key with y = p + 3 under a junk
    # signature, a tampered signature, and a VALID signature under the
    # non-canonical encoding y = p + 1 of the identity (R = sB)
    pubs, msgs, sigs = (list(x) for x in state["batch"])
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
    launched = {k for k, v in state["main_launches"].items() if v}
    check(launched == DEFAULT_KERNELS, "the default engine launched "
          f"{sorted(launched)}, not {sorted(DEFAULT_KERNELS)}: "
          f"{state['main_launches']}")
    state["batch_items"] = (pubs, msgs, sigs)
    state["batch_packed"] = ed.pack_rlc(*state["batch"])
    return {"clean_seconds": clean_s, "clean_sigs_per_s": N_BATCH / clean_s,
            "clean_rlc_verify_seconds": clean_rlc_s,
            "hostile_seconds": hostile_s, "persig_seconds": persig.seconds,
            "oracle_seconds": oracle_s,
            "launches": {k: state["main_launches"][k] - before[k]
                         for k in before},
            "main_path_launches": state["main_launches"]}


# -- phase 5: the engine configurations -------------------------------------------

def phase_engines(state, torch):
    """Each configuration drives the commit, the window and (where
    listed) the batch through the normal entry points, with the counts
    set to 0 just before and read just after; it must launch exactly its
    kernels.  The A-table cache starts empty, so the window's programs
    are the whole one and the cached-A one."""
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.types import validation as val

    commits = [(h, state["commits"][h]) for h in state["heights"]]
    rows = []
    state["engine_launches"] = {}
    for name, flags, needed, with_batch in ENGINES:
        _set_engine(flags)
        try:
            ed._A_TABLE_CACHE = ed.ATableCache()
            _zero_counts()
            t0 = time.perf_counter()
            rec = {"configuration": name, "flags": flags}
            rec["commit_accept_seconds"], rec["commit_reject_seconds"] = \
                _commit_accept_reject(state, val)
            with _Timed(ed, "rlc_verify", torch) as rlc:
                t1 = time.perf_counter()
                n = _run_window(state, val, commits)
                rec["window_seconds"] = time.perf_counter() - t1
                rec["window_sigs_per_s"] = n / rec["window_seconds"]
                rec["window_rlc_verify_seconds"] = rlc.seconds
            rec["window_reject_seconds"], _, _ = _window_reject(
                state, val, commits)
            if with_batch:
                rec["batch_seconds"], rec["batch_rlc_verify_seconds"] = \
                    _clean_batch(state, torch)
                rec["batch_sigs_per_s"] = N_BATCH / rec["batch_seconds"]
            rec["seconds"] = time.perf_counter() - t0
            counts = _counts()
        finally:
            _set_engine({})
        launched = {k for k, v in counts.items() if v}
        check(launched == needed, f"{name} launched {sorted(launched)}, "
              f"not {sorted(needed)}: {counts}")
        rec["launches"] = counts
        state["engine_launches"][name] = counts
        rows.append(rec)
    _zero_counts()
    return {"configurations": rows}


# -- phase 6: kernel vs plain --------------------------------------------------

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


def _hostile_digits(torch, mags):
    """mags with magnitudes 17, 31 and -1 in the first and last windows:
    each selects the identity."""
    m = mags.clone()
    bad = torch.tensor([17, 31, -1], dtype=torch.int32, device=m.device)
    m[0, :3] = bad
    m[-1, -3:] = bad
    return m


def _exact(a, b):
    return int((a - b).abs().max())


def phase_kernels(state, torch):
    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.ops import cuda_decompress as cd
    from cometbft_tpu_torch.ops import cuda_msm as cm
    from cometbft_tpu_torch.ops import ed25519 as dev
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
    k2, k3, k5, k6, k7 = [], [], [], [], []
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
            nwin, width = (int(d) for d in mags.shape)
            digit_sets = [(label, mags)]
            if label == "window" and side == "R":
                digit_sets.append(("digits outside 0..16",
                                   _hostile_digits(torch, mags)))
            for phase, mg in digit_sets:
                part = cm.msm_window_major(tab, mg, negs, group=1)
                e3 = _exact(part, cm.msm_window_major_plain(tab, mg, negs))
                check(e3 == 0, f"K3 {phase}/{side} differs by {e3}")
                k3.append({"shape": [nwin, width], "max_abs_err": e3,
                           "args": (tab, mg, negs), "phase": phase,
                           "partials": part})
                for requested in (4, 13):
                    g = cm.group_for(nwin, requested)
                    p5 = cm.msm_window_major_grouped(tab, mg, negs, g)
                    e5 = _exact(p5, cm.msm_window_major_grouped_plain(
                        tab, mg, negs, g))
                    vs_k3 = _exact(p5, part)
                    check(e5 == 0 and vs_k3 == 0, f"K5 {phase}/{side} G {g} "
                          f"differs from plain by {e5}, from K3 by {vs_k3}")
                    k5.append({"shape": [nwin, width], "group": g,
                               "max_abs_err": e5, "vs_k3": vs_k3,
                               "args": (tab, mg, negs, g), "phase": phase})
                blk = cm.loop_blk(width)
                p6 = cm.msm_window_loop(tab, mg, negs, blk)
                e6 = _exact(p6, cm.msm_window_loop_plain(tab, mg, negs, blk))
                sum_err = _proj_err(torch, fe, dev._tree_reduce(p6, 1),
                                    dev._tree_reduce(part, 1))
                check(e6 == 0 and sum_err == 0, f"K6 {phase}/{side} differs "
                      f"from plain by {e6}; its sum from K3's by {sum_err}")
                k6.append({"shape": [nwin, width], "blk": blk,
                           "max_abs_err": e6, "args": (tab, mg, negs, blk),
                           "phase": phase})
                for j in (0, nwin - 1):
                    p7 = cm.select_tree(tab, mg[j], negs[j], blk)
                    e7 = _exact(p7, cm.select_tree_plain(tab, mg[j], negs[j],
                                                         blk))
                    check(e7 == 0, f"K7 {phase}/{side} row {j} differs by "
                          f"{e7}")
                    k7.append({"shape": [width], "row": j, "blk": blk,
                               "max_abs_err": e7,
                               "args": (tab, mg[j], negs[j], blk),
                               "phase": phase})
    cases["ed25519_table17_neg"] = k2
    cases["ed25519_msm_window_major"] = k3
    cases["ed25519_msm_window_major_grouped"] = k5
    cases["ed25519_msm_window_loop"] = k6
    cases["ed25519_select_tree"] = k7
    k4 = []
    bad = convert.packed_from_numpy(state["window_packed_bad"], DEVICE)
    bad_pa, bad_pr = (cm.msm_window_major(cm.table17_neg(cd.decompress(w)[0]),
                                          m, n, group=1)
                      for w, m, n in ((bad[0], bad[2], bad[3]),
                                      (bad[1], bad[4], bad[5])))
    main_k3 = [c for c in k3 if c["phase"] in ("window", "batch")]
    for label, want, pa, pr in (
            ("batch accept", True, main_k3[2]["partials"],
             main_k3[3]["partials"]),
            ("window accept", True, main_k3[0]["partials"],
             main_k3[1]["partials"]),
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
    keep = ("shape", "max_abs_err", "group", "vs_k3", "blk", "row")
    return {"tolerance": "exact: integer limbs, frozen and projective",
            "compared": {k: [{"phase": c.get("phase", "batch"),
                              **{f: c[f] for f in keep if f in c}}
                             for c in v] for k, v in cases.items()}}


# -- phase 7: timing -------------------------------------------------------------

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
    once.  An MSM over all windows counts its whole table; one window of
    select-tree needs one table row per lane."""
    from cometbft_tpu_torch.ops import cuda_msm as cm

    if name == "ed25519_decompress":
        w = case["args"][0].shape[-1]
        return w * DECOMPRESS, w * (32 + 320 + 4)
    if name == "ed25519_table17_neg":
        w = case["args"][0].shape[-1]
        return w * TABLE, w * (320 + 17 * 320)
    if name in ("ed25519_msm_window_major",
                "ed25519_msm_window_major_grouped"):
        mags = case["args"][1]
        nwin, w = mags.shape
        nblk = -(-w // 32)
        ops = nwin * (w - 1) * ADD + (nwin - 1) * (4 * DBL + DBL_T + ADD)
        return ops, w * 17 * 320 + nwin * w * 5 + nblk * 320
    if name == "ed25519_msm_window_loop":
        mags, blk = case["args"][1], case["args"][3]
        nwin, w = mags.shape
        blk, out_l, nblk = cm.loop_geometry(w, blk)
        nout = nblk * out_l
        ops = (nwin * nblk * (blk - out_l) * ADD
               + (nwin - 1) * nout * (4 * DBL + DBL_T + ADD))
        return ops, w * 17 * 320 + nwin * w * 5 + nout * 320
    if name == "ed25519_select_tree":
        w, blk = case["args"][1].shape[-1], case["args"][3]
        blk, out_l, nblk = cm.loop_geometry(w, blk)
        return nblk * (blk - out_l) * ADD, w * (320 + 5) + nblk * out_l * 320
    pa, pr = case["args"]
    n = pa.shape[-1] + pr.shape[-1]
    return (n - 1) * ADD + 3 * DBL, n * 320 + 4


def phase_timing(state, torch):
    from cometbft_tpu_torch.ops import cuda_decompress as cd
    from cometbft_tpu_torch.ops import cuda_msm as cm

    plain = {"ed25519_decompress": cd.decompress_plain,
             "ed25519_table17_neg": cm.table17_neg_plain,
             "ed25519_msm_window_major": cm.msm_window_major_plain,
             "ed25519_fold_verify": cm.fold_verify_plain,
             "ed25519_msm_window_major_grouped":
                 cm.msm_window_major_grouped_plain,
             "ed25519_msm_window_loop": cm.msm_window_loop_plain,
             "ed25519_select_tree": cm.select_tree_plain}
    saved = _counts()
    peak_ops = 132 * INT32_LANES_PER_SM_CLK * state["sm_clock_hz"]
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
                           "max_abs_err": case["max_abs_err"],
                           **{k: case[k] for k in ("group", "blk", "row")
                              if k in case}})
        top = max(shapes, key=lambda s: s["ms"])
        by_path = {"main": state["main_launches"][name],
                   **{cfg: c[name]
                      for cfg, c in state["engine_launches"].items()}}
        launches = (by_path["main"] if name in DEFAULT_KERNELS else
                    sum(v for k, v in by_path.items() if k != "main"))
        source, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": CSRC + source,
                     "replaces": replaces, "launches": launches,
                     "launches_by_path": by_path,
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
