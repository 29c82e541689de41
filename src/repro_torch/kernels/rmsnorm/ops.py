"""RMSNorm as the model calls it.

:func:`rmsnorm` runs the hand-written CUDA kernel (``csrc/rmsnorm.cu``) on
CUDA tensors and its plain PyTorch version (:func:`~.ref.rmsnorm_reference`)
on CPU tensors.  A CUDA input either launches the kernel or raises; there
is no fallback.

The kernel replaces the reference package's Pallas TPU kernel
``kernels/rmsnorm/rmsnorm.py:_rmsnorm_kernel``.  It is bound by bytes; see
the note at the top of the CUDA source.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import KernelLibrary
from .ref import rmsnorm_reference


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_launch.argtypes = [ptr, ptr, ptr, i32, i32, ctypes.c_float, i32, ptr]
    lib.rmsnorm_launch.restype = ctypes.c_int


LIBRARY = KernelLibrary("rmsnorm", Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu", _bind)

#: Input types the kernel takes, with the code its C entry point expects.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm of ``x`` over its last axis with per-feature ``gain``; the
    output has ``x``'s shape and dtype."""
    if x.device.type == "cpu":
        return rmsnorm_reference(x, gain, eps)
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
    rows = x.numel() // d if d else 0
    if rows >= 2**31 or d >= 2**31:
        raise ValueError("x too large for int32 row and column counts")
    g = gain.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        rc = lib.rmsnorm_launch(
            x.data_ptr(), g.data_ptr(), out.data_ptr(), rows, d, float(eps),
            DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"rmsnorm launch failed: CUDA error {rc}")
    rmsnorm.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
rmsnorm.launches = 0
