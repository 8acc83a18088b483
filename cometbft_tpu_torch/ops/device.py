"""Device resolution for the port's entry points, and the shared
launch plumbing of the kernel wrappers.

The entry points take `device=`, default "cuda".  Without a card they
raise unless the caller passes device="cpu", which runs every kernel's
plain torch version on the host: nothing falls back to the CPU quietly.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch


def resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass device='cpu' to run the "
                "plain versions on the host")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


_CONSTANTS: dict = {}


def constant(arr: np.ndarray, device, dtype) -> torch.Tensor:
    """A host constant as a `dtype` tensor on `device`, copied there on
    first use and kept: a copy from pageable host memory inside a
    program would make the host wait for the card's queue.  Callers
    must not write to it."""
    arr = np.asarray(arr)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), dtype,
           torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = torch.as_tensor(arr).to(dtype=dtype, device=device)
        _CONSTANTS[key] = t
    return t


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def require(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Raise unless t has the dtype and shape (None = any size) the
    kernel takes."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
