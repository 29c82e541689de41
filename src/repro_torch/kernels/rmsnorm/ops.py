"""RMSNorm as the model calls it, alone or after the residual add.

:func:`rmsnorm` and :func:`add_rmsnorm` run the hand-written CUDA kernel
(``csrc/rmsnorm.cu``) on CUDA tensors and their plain PyTorch versions
(:mod:`.ref`) on CPU tensors.  A CUDA input either launches the kernel or
raises; there is no fallback.

The kernel replaces the reference package's Pallas TPU kernel
``kernels/rmsnorm/rmsnorm.py:_rmsnorm_kernel``; :func:`add_rmsnorm` also
takes the residual add before the norm.  The note at the top of the CUDA
source states what bounds it and the fixed summation order that makes
``add_rmsnorm(x, delta)``'s norm bit for bit ``rmsnorm(x + delta)``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import KernelLibrary
from .ref import add_rmsnorm_reference, rmsnorm_reference


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_launch.argtypes = [ptr] * 5 + [i32, i32, ctypes.c_float, i32, ptr]
    lib.rmsnorm_launch.restype = ctypes.c_int


LIBRARY = KernelLibrary("rmsnorm", Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu", _bind)

#: Input types the kernel takes, with the code its C entry point expects.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x: torch.Tensor, gain: torch.Tensor, delta: torch.Tensor | None) -> int:
    """Raises on what the kernel does not take; returns the row count."""
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cuda or cpu, not {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    d = x.shape[-1]
    if tuple(gain.shape) != (d,):
        raise ValueError(f"gain must have shape ({d},), got {tuple(gain.shape)}")
    if gain.device != x.device:
        raise ValueError(f"gain is on {gain.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if delta is not None:
        if delta.device != x.device:
            raise ValueError(f"delta is on {delta.device}, x on {x.device}")
        if delta.dtype != x.dtype or delta.shape != x.shape:
            raise ValueError(f"delta must match x ({x.dtype}, {tuple(x.shape)}), "
                             f"got {delta.dtype}, {tuple(delta.shape)}")
        if not delta.is_contiguous():
            raise ValueError("delta must be contiguous")
    rows = x.numel() // d if d else 0
    if rows >= 2**31 or d >= 2**31:
        raise ValueError("x too large for int32 row and column counts")
    return rows


def _launch(x, delta, gain, s, h, rows: int, eps: float) -> None:
    """One launch on the current stream of ``x``'s card, as a raw handle;
    the card is made current only when it is not already."""
    lib = LIBRARY.load()
    args = (x.data_ptr(), None if delta is None else delta.data_ptr(), gain.data_ptr(),
            None if s is None else s.data_ptr(), h.data_ptr(), rows, x.shape[-1], float(eps),
            DTYPES[x.dtype])
    index = x.get_device()
    if index == torch.cuda.current_device():
        rc = lib.rmsnorm_launch(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = lib.rmsnorm_launch(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"rmsnorm launch failed: CUDA error {rc}")


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm of ``x`` over its last axis with per-feature ``gain``; the
    output has ``x``'s shape and dtype."""
    if x.device.type == "cpu":
        return rmsnorm_reference(x, gain, eps)
    rows = _check(x, gain, None)
    g = gain.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    if rows == 0:
        return out
    _launch(x, None, g, None, out, rows, eps)
    rmsnorm.launches += 1
    return out


def add_rmsnorm(x: torch.Tensor, delta: torch.Tensor | None, gain: torch.Tensor,
                eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s, h)``: the residual sum ``s = x + delta`` (rounded to ``x``'s
    dtype, as ``x + delta`` rounds) and its RMSNorm ``h = rmsnorm(s, gain,
    eps)``, from one launch.  With ``delta`` None, ``s`` is ``x`` itself and
    ``h`` comes from :func:`rmsnorm`."""
    if delta is None:
        return x, rmsnorm(x, gain, eps)
    if x.device.type == "cpu":
        return add_rmsnorm_reference(x, delta, gain, eps)
    rows = _check(x, gain, delta)
    g = gain.to(torch.float32).contiguous()
    s, h = torch.empty_like(x), torch.empty_like(x)
    if rows == 0:
        return s, h
    _launch(x, delta, g, s, h, rows, eps)
    add_rmsnorm.launches += 1
    return s, h


#: Kernel launches since the count was last set to 0.
rmsnorm.launches = 0
add_rmsnorm.launches = 0
