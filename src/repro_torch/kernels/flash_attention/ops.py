"""Flash attention as the model's prefill calls it, in the model layout
(B, S, H, hd).

:func:`flash_attention` runs the hand-written CUDA kernel
(``csrc/flash_attention.cu``) on CUDA tensors and its plain PyTorch version
(:func:`~.ref.flash_attention_reference`) on CPU tensors.  A CUDA input
either launches the kernel or raises; there is no fallback.  The kernel
reads the model layout directly, so no transpose or padding happens here.

The kernel replaces the reference package's Pallas TPU kernel
``kernels/flash_attention/flash_attention.py:_flash_kernel``; see the note
at the top of the CUDA source for what bounds it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import KernelLibrary
from .ref import flash_attention_reference

#: Largest head_dim the kernel takes (its accumulator is 4 x 8 per thread).
MAX_HEAD_DIM = 128
#: Shared memory a block may use once the kernel opts in (H100: 227 KB).
SMEM_LIMIT_BYTES = 232_448
#: Input types the kernel takes, with the code its C entry point expects.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [ptr] * 4 + [i32] * 5 + [ctypes.c_float] + [i32] * 3 + [ptr]
    )
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [i32]
    lib.flash_attention_smem_bytes.restype = ctypes.c_size_t


LIBRARY = KernelLibrary(
    "flash_attention",
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    _bind,
)


def _check(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, S, heads, head_dim)")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    for name, t, shape in (("k", k, (B, S, KV, hd)), ("v", v, (B, S, KV, hd))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in DTYPES:
        raise ValueError(f"q, k and v must be float32 or bfloat16, got {q.dtype}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} is over the kernel's {MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if q.numel() >= 2**31 or k.numel() >= 2**31:
        raise ValueError("q, k or v too large for the kernel's int32 positions")


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention in the model layout: q (B, S, H, hd), k and v (B, S, KV, hd)
    with H a multiple of KV; returns (B, S, H, hd) in q's dtype.  ``scale``
    defaults to ``hd ** -0.5``; the model passes ``1 / hd ** 0.5``."""
    hd = q.shape[-1]
    if scale is None:
        scale = hd ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v, window)
    B, S, H, _ = q.shape
    KV = k.shape[2]
    lib = LIBRARY.load()
    smem = lib.flash_attention_smem_bytes(hd)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"head_dim {hd} needs {smem} bytes of shared memory, over the "
            f"{SMEM_LIMIT_BYTES}-byte limit"
        )
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, KV, hd, float(scale), int(causal),
            0 if window is None else int(window), DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
flash_attention.launches = 0
