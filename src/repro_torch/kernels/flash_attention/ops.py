"""Flash attention as the model's prefill calls it, in the model layout
(B, S, H, hd), and its backward.

:func:`flash_attention` runs the hand-written CUDA kernel
(``csrc/flash_attention.cu``) on CUDA tensors and its plain PyTorch version
(:func:`~.ref.flash_attention_reference`) on CPU tensors.  A CUDA input
either launches the kernel or raises; there is no fallback.  The kernel
reads the model layout directly, so no transpose or padding happens here.

The kernel replaces the reference package's Pallas TPU kernel
``kernels/flash_attention/flash_attention.py:_flash_kernel``; see the note
at the top of the CUDA source for what bounds it.

Gradients.  On the card, under grad mode with an input that requires
grad, :func:`flash_attention` goes through a ``torch.autograd.Function``
whose forward is the same kernel, here also writing each query row's
log-sum-exp (``flash_attention_lse_launch``; the output is the same bits),
and whose backward is the hand-written backward kernel
(``csrc/flash_attention_bwd.cu``), called through
:func:`flash_attention_backward` with those statistics; without grad it
launches the forward alone, as serving does, and writes no statistics.
On the CPU the plain version is differentiable as it is.

Counting.  Each launch, forward or backward, reports its FLOPs and bytes
(:mod:`.cost`) to the active counters (:mod:`repro_torch.kernels._cost`).
On ``FakeTensor`` or meta inputs (a dry run), and on CPU inputs while a
counter is active, the wrappers run a stand-in instead: empty outputs and,
under grad, the row statistics the card keeps (a dry run), or the plain
versions, with the same cost reported and no launch.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .._build import KernelLibrary, refuse_dtensor
from .._cost import StandIn, add_kernel, counted, filled, is_fake, run_stand_in, stands_in
from .cost import flash_backward_cost, flash_cost
from .ref import (
    check_key_length,
    flash_attention_backward_reference,
    flash_attention_lse_reference,
    flash_attention_reference,
)

#: Largest head_dim the kernel takes (a warp's accumulator is 16 x 128).
MAX_HEAD_DIM = 128
#: Shared memory a block may use once the kernel opts in (H100: 227 KB).
SMEM_LIMIT_BYTES = 232_448
#: Input types the kernel takes, with the code its C entry point expects.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [ptr] * 4 + [i32] * 6 + [ctypes.c_float] + [i32] * 5 + [ptr]
    )
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_lse_launch.argtypes = (
        [ptr] * 5 + [i32] * 6 + [ctypes.c_float] + [i32] * 5 + [ptr]
    )
    lib.flash_attention_lse_launch.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [i32]
    lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
    lib.flash_attention_heads_per_block.argtypes = [i32] * 5
    lib.flash_attention_heads_per_block.restype = i32


def _bind_backward(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd_launch.argtypes = (
        [ptr] * 10 + [i32] * 6 + [ctypes.c_float] + [i32] * 4 + [ptr]
    )
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_blocks_per_sm.argtypes = [i32, i32]
    lib.flash_attention_bwd_blocks_per_sm.restype = i32
    lib.flash_attention_bwd_smem_bytes.argtypes = [i32]
    lib.flash_attention_bwd_smem_bytes.restype = ctypes.c_size_t


_CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = KernelLibrary("flash_attention", _CSRC / "flash_attention.cu", _bind)
BACKWARD_LIBRARY = KernelLibrary("flash_attention_bwd", _CSRC / "flash_attention_bwd.cu",
                                 _bind_backward)


def _check(q, k, v, causal, window, key_offset=None) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, S, heads, head_dim)")
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    if Sk == 0:
        raise ValueError("k and v hold no keys")
    check_key_length(S, Sk, causal, window, key_offset)
    for name, t, shape in (("k", k, (B, Sk, KV, hd)), ("v", v, (B, Sk, KV, hd))):
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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _forward(q, k, v, causal, window, scale, heads_per_block, lse=None,
             key_offset=None) -> torch.Tensor:
    """One forward launch on CUDA tensors; counts nothing.  With ``lse``, a
    (B, H, S) fp32 tensor, the launch also writes each query row's
    log-sum-exp into it.  ``key_offset``: k and v are the keys at those
    positions on (:func:`~.ref.check_key_length`)."""
    _check(q, k, v, causal, window, key_offset)
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    lib = LIBRARY.load()
    smem = lib.flash_attention_smem_bytes(hd)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"head_dim {hd} needs {smem} bytes of shared memory, over the "
            f"{SMEM_LIMIT_BYTES}-byte limit"
        )
    if heads_per_block is None:
        heads_per_block = lib.flash_attention_heads_per_block(
            B, S, H, KV, _sm_count(q.device.index or 0))
    elif heads_per_block not in (1, 2):
        raise ValueError(f"heads_per_block must be 1 or 2, got {heads_per_block}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        args = (B, S, Sk, H, KV, hd, float(scale), int(causal),
                0 if window is None else int(window), int(key_offset or 0), DTYPES[q.dtype],
                heads_per_block, torch.cuda.current_stream().cuda_stream)
        if lse is None:
            rc = lib.flash_attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                            out.data_ptr(), *args)
        else:
            _check_lse(lse, q)
            rc = lib.flash_attention_lse_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                out.data_ptr(), lse.data_ptr(), *args)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    return out


def _check_lse(lse, q) -> None:
    B, S, H, _ = q.shape
    if (tuple(lse.shape) != (B, H, S) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous ({B}, {H}, {S}) float32 tensor on {q.device}, "
                         f"got {lse.dtype} {tuple(lse.shape)} on {lse.device}")


def _cost(q, k, v, causal, window, lse: bool, key_offset=None) -> tuple[int, int]:
    """``(flops, bytes)`` of one forward launch on these inputs."""
    B, S, H, hd = q.shape
    mm, soft, nbytes = flash_cost(B, S, k.shape[1], H, k.shape[2], hd, v.shape[-1], causal, window,
                                  q.element_size(), lse, key_offset or 0)
    return mm + soft, nbytes


def _backward_cost(q, k, causal, window, key_offset=None) -> tuple[int, int]:
    """``(flops, bytes)`` of one backward launch on these inputs."""
    B, S, H, hd = q.shape
    mm, soft, nbytes = flash_backward_cost(B, S, k.shape[1], H, k.shape[2], hd, causal, window,
                                           q.element_size(), key_offset or 0)
    return mm + soft, nbytes


class _FlashStandIn(StandIn):
    """:func:`flash_attention` in a count: an empty output and, under grad,
    the (B, H, S) fp32 row statistics the card keeps, on fake inputs; the
    plain versions on real ones."""

    name, backward_name = "flash_attention", "flash_attention_backward"

    def __init__(self, causal, window, scale):
        self.causal, self.window, self.scale = causal, window, scale

    def outputs(self, inputs, grad):
        q, k, v = inputs
        fake = is_fake(q, k, v)
        B, S, H, _ = q.shape
        kept = (q.new_empty((B, H, S), dtype=torch.float32),) if fake and grad else ()
        return filled((torch.empty_like(q),), lambda: (flash_attention_reference(
            q, k, v, causal=self.causal, window=self.window, scale=self.scale),), fake), kept

    def cost(self, inputs, grad):
        return _cost(*inputs, self.causal, self.window, grad)

    def gradients(self, inputs, outputs, kept, grads):
        q, k, v = inputs
        out = filled((torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)),
                     lambda: flash_attention_backward_reference(
                         q, k, v, outputs[0], grads[0], causal=self.causal, window=self.window,
                         scale=self.scale), is_fake(q, k, v))
        return out, _backward_cost(q, k, self.causal, self.window)


class _FlashAttentionFunction(torch.autograd.Function):
    """:func:`flash_attention` on the card under grad: the forward kernel,
    writing each row's log-sum-exp beside the output, then
    :func:`flash_attention_backward`'s kernels.  The output (its ``D = Σ
    dout·out`` per row) and the statistics are saved for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, heads_per_block):
        B, S, H, _ = q.shape
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        out = _forward(q, k, v, causal, window, scale, heads_per_block, lse=lse)
        if out.numel():
            flash_attention.launches += 1
            add_kernel("flash_attention", _cost, q, k, v, causal, window, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.options = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.options
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout, causal=causal, window=window,
                                              scale=scale, lse=lse)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    scale: float | None = None,
                    heads_per_block: int | None = None) -> torch.Tensor:
    """Attention in the model layout: q (B, S, H, hd), k and v (B, Sk, KV,
    hd) with H a multiple of KV; returns (B, S, H, hd) in q's dtype.  Sk is
    S in a causal or windowed call and may differ in a non-causal one (else
    ``ValueError``).  ``scale`` defaults to ``hd ** -0.5``; the model passes
    ``1 / hd ** 0.5``.  Differentiable on both devices: on the card under
    grad the backward kernel computes the gradients.

    The kernel takes one query head per block when that grid fits in one
    wave of one block per SM, else two (``flash_attention_heads_per_block``
    in the CUDA source).  ``heads_per_block`` forces it, for tests and timing
    only."""
    refuse_dtensor("flash_attention", q, k, v)
    hd = q.shape[-1]
    if scale is None:
        scale = hd ** -0.5
    if stands_in(q, k, v):
        return run_stand_in(_FlashStandIn(causal, window, scale), q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttentionFunction.apply(q, k, v, causal, window, scale, heads_per_block)
    out = _forward(q, k, v, causal, window, scale, heads_per_block)
    if out.numel():
        flash_attention.launches += 1
        add_kernel("flash_attention", _cost, q, k, v, causal, window, False)
    return out


def flash_attention_with_lse(q, k, v, *, causal: bool = True, window: int | None = None,
                             scale: float | None = None, key_offset: int | None = None):
    """``(out, lse)``: one launch of the forward kernel as the autograd
    Function runs it, ``out`` the same bits as :func:`flash_attention`'s
    and ``lse`` (B, H, S) fp32 each query row's log-sum-exp of its visible
    scaled scores, as :func:`flash_attention_backward` takes it.  Counts
    one forward launch.  CPU tensors run the plain version
    (:func:`~.ref.flash_attention_lse_reference`).

    ``key_offset`` makes k and v one shard of the keys, those at positions
    ``key_offset ... key_offset + Sk - 1`` of the queries' sequence (causal,
    no window): a row before the shard sees no key, its output 0 and its
    log-sum-exp -1e30.  Attention split over the keys combines the
    shards' outputs by these statistics (:mod:`repro_torch.models.attention`)."""
    refuse_dtensor("flash_attention_with_lse", q, k, v)
    hd = q.shape[-1]
    if scale is None:
        scale = hd ** -0.5
    B, S, H, _ = q.shape
    if stands_in(q, k, v):
        return counted("flash_attention", _cost(q, k, v, causal, window, True, key_offset),
                       lambda: filled((torch.empty_like(q),
                                       q.new_empty((B, H, S), dtype=torch.float32)),
                                      lambda: flash_attention_lse_reference(
                                          q, k, v, causal=causal, window=window, scale=scale,
                                          key_offset=key_offset), is_fake(q, k, v)))
    if q.device.type == "cpu":
        return flash_attention_lse_reference(q, k, v, causal=causal, window=window, scale=scale,
                                             key_offset=key_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_with_lse runs on cuda or cpu, not {q.device}")
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    out = _forward(q, k, v, causal, window, scale, None, lse=lse, key_offset=key_offset)
    if out.numel():
        flash_attention.launches += 1
        add_kernel("flash_attention", _cost, q, k, v, causal, window, True, key_offset)
    return out, lse


def flash_attention_backward(q, k, v, out, dout, *, causal: bool = True,
                             window: int | None = None, scale: float | None = None, lse=None,
                             key_offset: int | None = None):
    """The gradients ``(dq, dk, dv)`` of ``out = flash_attention(q, k, v,
    causal=..., window=..., scale=...)`` given ``dout = dL/dout``, each in
    its input's dtype: the backward kernel's two launches (dq with each
    row's statistics, then dk and dv) on CUDA tensors, its plain version
    (:func:`~.ref.flash_attention_backward_reference`) on CPU tensors.
    ``lse`` is the forward's row statistics, as
    :func:`flash_attention_with_lse` (or the autograd Function) gives them;
    without it the wrapper runs that forward launch first (counted in
    ``flash_attention.launches``).  The plain version recomputes them.

    For one shard of the keys (``key_offset``, as in
    :func:`flash_attention_with_lse`) ``out`` and ``lse`` are the whole
    row's, combined over the shards: dq is then the shard's part of the
    row's dq, dk and dv the shard's keys' whole gradients."""
    refuse_dtensor("flash_attention_backward", q, k, v, out, dout, lse)
    hd = q.shape[-1]
    if scale is None:
        scale = hd ** -0.5
    if stands_in(q, k, v, out, dout):
        return counted("flash_attention_backward",
                       _backward_cost(q, k, causal, window, key_offset),
                       lambda: filled((torch.empty_like(q), torch.empty_like(k),
                                       torch.empty_like(v)),
                                      lambda: flash_attention_backward_reference(
                                          q, k, v, out, dout, causal=causal, window=window,
                                          scale=scale, lse=lse, key_offset=key_offset),
                                      is_fake(q, k, v, out, dout)))
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, out, dout, causal=causal,
                                                  window=window, scale=scale, lse=lse,
                                                  key_offset=key_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward runs on cuda or cpu, not {q.device}")
    _check(q, k, v, causal, window, key_offset)
    dout = dout.contiguous()
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q ({q.dtype}, {tuple(q.shape)}, {q.device}), "
                             f"got {t.dtype}, {tuple(t.shape)}, {t.device}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    B, S, H, _ = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    lib = BACKWARD_LIBRARY.load()
    smem = lib.flash_attention_bwd_smem_bytes(hd)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"head_dim {hd} needs {smem} bytes of shared memory in the backward, "
                         f"over the {SMEM_LIMIT_BYTES}-byte limit")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    if lse is None:
        lse = flash_attention_with_lse(q, k, v, causal=causal, window=window, scale=scale,
                                       key_offset=key_offset)[1]
    _check_lse(lse, q)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            B, S, Sk, H, KV, hd, float(scale), int(causal),
            0 if window is None else int(window), int(key_offset or 0), DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA error {rc}")
    flash_attention_backward.launches += 1
    add_kernel("flash_attention_backward", _backward_cost, q, k, causal, window, key_offset)
    return dq, dk, dv


#: Kernel launches since the count was last set to 0.
flash_attention.launches = 0
flash_attention_backward.launches = 0
