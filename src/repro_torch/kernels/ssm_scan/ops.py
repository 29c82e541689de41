"""The selective scan as the Mamba block calls it.

:func:`ssm_scan` runs the hand-written CUDA kernel (``csrc/ssm_scan.cu``)
on CUDA tensors and its plain PyTorch version
(:func:`~.ref.ssm_scan_reference`) on CPU tensors.  A CUDA input either
launches the kernel or raises; there is no fallback.

The kernel replaces the reference package's Pallas TPU kernel
``kernels/ssm_scan/ssm_scan.py:_ssm_kernel``; see the note at the top of
the CUDA source for what bounds it.  It takes any S and D, so nothing is
padded here.

Layouts: ``bmat`` and ``cmat`` arrive as slices of the block's ``x_proj``
output, so the wrapper passes their batch and step strides to the kernel
instead of copying them; only a last-axis stride other than 1 makes it
call ``.contiguous()`` first.  ``dt`` and ``x`` are made contiguous (the
block's are already), and ``a`` and ``h0`` are converted to contiguous fp32.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import KernelLibrary
from .ref import ssm_scan_reference

#: Largest state width N the kernel takes (four lanes per channel keep N / 4
#: states each in registers).
MAX_STATE = 16
#: Largest batch (the kernel's grid has one row of blocks per batch row).
MAX_BATCH = 65535
#: Input types the kernel takes, with the code its C entry point expects.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssm_scan_launch.argtypes = [ptr] * 8 + [i32] * 4 + [i64] * 4 + [i32, ptr]
    lib.ssm_scan_launch.restype = ctypes.c_int


LIBRARY = KernelLibrary("ssm_scan", Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu", _bind)


def _check(dt, x, bmat, cmat, a, h0) -> None:
    if dt.dim() != 3:
        raise ValueError(f"dt must be (B, S, D), got {tuple(dt.shape)}")
    B, S, D = dt.shape
    if a.dim() != 2 or a.shape[0] != D:
        raise ValueError(f"a must be ({D}, N), got {tuple(a.shape)}")
    N = a.shape[1]
    for name, t, shape in (("x", x, (B, S, D)), ("bmat", bmat, (B, S, N)),
                           ("cmat", cmat, (B, S, N)), ("h0", h0, (B, D, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    for name, t in (("x", x), ("bmat", bmat), ("cmat", cmat), ("a", a), ("h0", h0)):
        if t.device != dt.device:
            raise ValueError(f"{name} is on {t.device}, dt on {dt.device}")
    for name, t in (("x", x), ("bmat", bmat), ("cmat", cmat)):
        if t.dtype != dt.dtype:
            raise ValueError(f"{name} is {t.dtype}, dt is {dt.dtype}")
    if dt.dtype not in DTYPES:
        raise ValueError(f"dt, x, bmat and cmat must be float32 or bfloat16, got {dt.dtype}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"state width {N} is outside the kernel's 1..{MAX_STATE}")
    if B > MAX_BATCH:
        raise ValueError(f"batch {B} is over the kernel's {MAX_BATCH}")
    if D >= 2**31 or S >= 2**31:
        raise ValueError("S or D too large for the kernel's int32 counts")


def ssm_scan(dt, x, bmat, cmat, a, h0):
    """The selective scan of ``x`` with step sizes ``dt`` (B, S, D), input
    and output projections ``bmat`` and ``cmat`` (B, S, N), decay ``a``
    (D, N, negative) and initial state ``h0`` (B, D, N).  Returns
    (y (B, S, D), hT (B, D, N)), both fp32.

    Not differentiable on the card: a CUDA call under grad mode with an
    input that requires grad raises ``NotImplementedError`` rather than
    return outputs without gradients.  On the CPU the plain version is
    differentiable."""
    if dt.device.type == "cpu":
        return ssm_scan_reference(dt, x, bmat, cmat, a, h0)
    if dt.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu, not {dt.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (dt, x, bmat, cmat, a, h0)):
        raise NotImplementedError(
            "ssm_scan has no backward kernel on the card yet (ROADMAP queue 1, item 3e (i)): "
            "call it under torch.no_grad() or on CPU tensors")
    _check(dt, x, bmat, cmat, a, h0)
    B, S, D = dt.shape
    N = a.shape[1]
    dt, x = dt.contiguous(), x.contiguous()
    bmat = bmat if bmat.stride(-1) == 1 else bmat.contiguous()
    cmat = cmat if cmat.stride(-1) == 1 else cmat.contiguous()
    a = a.to(torch.float32).contiguous()
    h0 = h0.to(torch.float32).contiguous()
    y = torch.empty((B, S, D), dtype=torch.float32, device=dt.device)
    hT = torch.empty((B, D, N), dtype=torch.float32, device=dt.device)
    if B == 0 or D == 0:
        return y, hT
    lib = LIBRARY.load()
    with torch.cuda.device(dt.device):
        rc = lib.ssm_scan_launch(
            dt.data_ptr(), x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            a.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
            B, S, D, N, bmat.stride(0), bmat.stride(1), cmat.stride(0), cmat.stride(1),
            DTYPES[dt.dtype], torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"ssm_scan launch failed: CUDA error {rc}")
    ssm_scan.launches += 1
    return y, hT


#: Kernel launches since the count was last set to 0.
ssm_scan.launches = 0
