"""Build and load the port's CUDA kernels.

Each `ops/csrc/<name>.cu` compiles with `nvcc` into a shared library with
a plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds).  The library lands in `ops/build/` under a name keyed by
a hash of every source and header in `csrc/` and of the flags, so an
edited source rebuilds and an unchanged one is reused.  Only the sources
in the repository are used.  Where there is no `nvcc`, or it fails, the
build raises with the compiler's output: nothing falls back to a plain
version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = [ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# the C interface of each library: function -> argument types (pointers
# and streams as c_void_p, or ctypes would cut them to 32 bits)
SIGNATURES = {
    "ed25519_kernels": {
        "ed25519_decompress": [_P, _I64, _P, _P, _P],
        "ed25519_table17_neg": [_P, _I64, _P, _P],
        "ed25519_msm_window_major": [_P, _P, _P, _I64, _I32, _I32, _I64, _P,
                                     _P, _P],
        "ed25519_fold_verify": [_P, _I64, _P, _I64, _P, _P],
        "ed25519_msm_warps": [],
        "ed25519_chain_threads": [],
        "ed25519_fold_slots": [],
    },
    "ed25519_engines": {
        "ed25519_msm_window_loop": [_P, _P, _P, _I64, _I32, _I32, _I32, _I64,
                                    _P, _P, _P],
        "ed25519_select_tree": [_P, _P, _P, _I64, _I32, _I32, _I64, _P, _P],
        "ed25519_msm_window_major_grouped": [_P, _P, _P, _I64, _I32, _P, _P,
                                             _P],
        "ed25519_loop_threads": [],
        "ed25519_group_warps": [],
        "ed25519_group_quads": [],
    },
    "ed25519_persig": {
        "ed25519_verify_ladder": [_P] * 5 + [_I64, _P, _P, _P],
        "ed25519_persig_threads": [],
    },
    "sha2_kernels": {
        "sha512_blocks": [_P, _P, _P, _I64, _I32, _P, _P, _P],
        "sha256_blocks": [_P, _P, _I64, _I32, _P, _P],
    },
    "secp256k1_kernels": {
        "secp_q_tables": [_P, _P, _I64, _P, _P, _P, _P],
        "secp_q_tables_walk": [_P, _P, _I64, _P, _P, _P],
        "secp_q_tables_rows": [_P, _I64, _P, _P],
        "secp_msm_verify": [_P] * 13 + [_I64, _I64, _P, _P],
        "secp_ladder": [_P] * 8 + [_I64, _P, _P],
        "secp_threads": [],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per library: {"seconds": build time or 0.0 when reused, "log": nvcc output}
build_info: dict[str, dict] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _key(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh") and (f.suffix == ".cuh"
                                            or f.stem == name):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_key(name)}.so"


def build(names: list[str]) -> None:
    """Compile every library in `names` that is not built yet, one nvcc
    per source, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = _target(name)
        if so.exists():
            build_info.setdefault(name, {"seconds": 0.0, "log": ""})
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (so, tmp, time.perf_counter(),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (so, tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (rc "
                          f"{proc.returncode}):\n{log}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib
