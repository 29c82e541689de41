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

Gradients.  On the card, under grad mode with an input that requires
grad, both go through a ``torch.autograd.Function`` whose forward is the
same kernel and whose backward is the hand-written backward kernel
(``csrc/rmsnorm_bwd.cu``), called through :func:`rmsnorm_backward` and
:func:`add_rmsnorm_backward`; without grad they launch the forward alone,
as serving does.  On the CPU the plain versions are differentiable as
they are.

Counting.  Each launch, forward or backward, reports its FLOPs and bytes
(:mod:`.cost`) to the active counters (:mod:`repro_torch.kernels._cost`).
On ``FakeTensor`` or meta inputs (a dry run), and on CPU inputs while a
counter is active, the wrappers run a stand-in instead: empty outputs (a
dry run) or the plain versions, with the same cost reported and no launch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import KernelLibrary, refuse_dtensor
from .._cost import StandIn, add_kernel, counted, filled, is_fake, run_stand_in, stands_in
from .cost import add_rmsnorm_cost, norm_backward_cost, rmsnorm_cost
from .ref import (
    add_rmsnorm_backward_reference,
    add_rmsnorm_reference,
    rmsnorm_backward_reference,
    rmsnorm_reference,
)


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_launch.argtypes = [ptr] * 5 + [i32, i32, ctypes.c_float, i32, ptr]
    lib.rmsnorm_launch.restype = ctypes.c_int


def _bind_backward(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_bwd_scratch.argtypes = [i32, i32]
    lib.rmsnorm_bwd_scratch.restype = ctypes.c_longlong
    lib.rmsnorm_bwd_launch.argtypes = [ptr] * 7 + [i32, i32, ctypes.c_float, i32, ptr]
    lib.rmsnorm_bwd_launch.restype = ctypes.c_int


_CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = KernelLibrary("rmsnorm", _CSRC / "rmsnorm.cu", _bind)
BACKWARD_LIBRARY = KernelLibrary("rmsnorm_bwd", _CSRC / "rmsnorm_bwd.cu", _bind_backward)

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


def _on_card(entry, args, index: int) -> int:
    """``entry(*args, stream)`` with the current stream of card ``index`` as
    a raw handle; the card is made current only when it is not already."""
    if index == torch.cuda.current_device():
        return entry(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return entry(*args, torch._C._cuda_getCurrentRawStream(index))


def _launch(x, delta, gain, s, h, rows: int, eps: float) -> None:
    """One launch on the current stream of ``x``'s card."""
    args = (x.data_ptr(), None if delta is None else delta.data_ptr(), gain.data_ptr(),
            None if s is None else s.data_ptr(), h.data_ptr(), rows, x.shape[-1], float(eps),
            DTYPES[x.dtype])
    rc = _on_card(LIBRARY.load().rmsnorm_launch, args, x.get_device())
    if rc != 0:
        raise RuntimeError(f"rmsnorm launch failed: CUDA error {rc}")


def _gain32(gain: torch.Tensor) -> torch.Tensor:
    """The gain as the kernels take it: contiguous fp32, copied only when
    it is not already."""
    if gain.dtype == torch.float32 and gain.is_contiguous():
        return gain
    return gain.to(torch.float32).contiguous()


def _forward(x, delta, gain, eps: float):
    """``(s, h)`` from one forward launch (``s`` is None without
    ``delta``); counts nothing."""
    rows = _check(x, gain, delta)
    g = _gain32(gain)
    s = None if delta is None else torch.empty_like(x)
    h = torch.empty_like(x)
    if rows:
        _launch(x, delta, g, s, h, rows, eps)
    return s, h


def _rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1] if x.shape[-1] else 0


def _cost(name: str, x: torch.Tensor, fused: bool) -> tuple[int, int]:
    if name == "rmsnorm":
        return rmsnorm_cost(_rows(x), x.shape[-1], x.element_size())
    if name == "add_rmsnorm":
        return add_rmsnorm_cost(_rows(x), x.shape[-1], x.element_size())
    return norm_backward_cost(_rows(x), x.shape[-1], fused, x.element_size())


def _report(name: str, x: torch.Tensor, fused: bool = False) -> None:
    """One launch of kernel ``name`` on the rows of ``x``, to the counters."""
    add_kernel(name, _cost, name, x, fused)


def _grad_buffers(x: torch.Tensor, gain: torch.Tensor) -> tuple:
    """``(dx, dgain)`` as the backward wrapper allocates them."""
    return torch.empty_like(x), x.new_empty(x.shape[-1], dtype=gain.dtype)


class _RMSNormStandIn(StandIn):
    """:func:`rmsnorm` in a count: empty outputs on fake inputs, the plain
    versions on real ones."""

    name, backward_name = "rmsnorm", "rmsnorm_backward"

    def __init__(self, eps: float):
        self.eps = eps

    def outputs(self, inputs, grad):
        x, gain = inputs
        return filled((torch.empty_like(x),), lambda: (rmsnorm_reference(x, gain, self.eps),),
                      is_fake(x, gain)), ()

    def cost(self, inputs, grad):
        x = inputs[0]
        return rmsnorm_cost(_rows(x), x.shape[-1], x.element_size())

    def gradients(self, inputs, outputs, kept, grads):
        x, gain = inputs
        out = filled(_grad_buffers(x, gain),
                     lambda: rmsnorm_backward_reference(x, grads[0], gain, self.eps),
                     is_fake(x, gain))
        return out, norm_backward_cost(_rows(x), x.shape[-1], False, x.element_size())


class _AddRMSNormStandIn(StandIn):
    """:func:`add_rmsnorm` in a count, as :class:`_RMSNormStandIn`."""

    name, backward_name = "add_rmsnorm", "add_rmsnorm_backward"

    def __init__(self, eps: float):
        self.eps = eps

    def outputs(self, inputs, grad):
        x, delta, gain = inputs
        return filled((torch.empty_like(x), torch.empty_like(x)),
                      lambda: add_rmsnorm_reference(x, delta, gain, self.eps),
                      is_fake(x, delta, gain)), ()

    def cost(self, inputs, grad):
        x = inputs[0]
        return add_rmsnorm_cost(_rows(x), x.shape[-1], x.element_size())

    def gradients(self, inputs, outputs, kept, grads):
        x, delta, gain = inputs
        s, (ds, dh) = outputs[0], grads
        if dh is None:               # the norm's output was not used: no launch
            dx = torch.zeros_like(s) if ds is None else ds
            return (dx, dx, torch.zeros_like(gain)), None
        dx, dgain = filled(_grad_buffers(x, gain),
                           lambda: add_rmsnorm_backward_reference(s, ds, dh, gain, self.eps),
                           is_fake(x, delta, gain))
        return (dx, dx, dgain), norm_backward_cost(_rows(x), x.shape[-1], ds is not None,
                                                  x.element_size())


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


class _RMSNormFunction(torch.autograd.Function):
    """:func:`rmsnorm` on the card under grad: the forward kernel, then
    :func:`rmsnorm_backward`'s kernel."""

    @staticmethod
    def forward(ctx, x, gain, eps):
        _, h = _forward(x, None, gain, eps)
        if h.numel():
            rmsnorm.launches += 1
            _report("rmsnorm", x)
        ctx.save_for_backward(x, gain)
        ctx.eps = eps
        return h

    @staticmethod
    def backward(ctx, dh):
        x, gain = ctx.saved_tensors
        dx, dgain = rmsnorm_backward(x, dh, gain, ctx.eps)
        return dx, dgain, None


class _AddRMSNormFunction(torch.autograd.Function):
    """:func:`add_rmsnorm` on the card under grad: the fused forward
    kernel, then :func:`add_rmsnorm_backward`'s kernel.  The residual sum
    ``s`` is saved for the backward (the norm's input)."""

    @staticmethod
    def forward(ctx, x, delta, gain, eps):
        ctx.set_materialize_grads(False)
        s, h = _forward(x, delta, gain, eps)
        if h.numel():
            add_rmsnorm.launches += 1
            _report("add_rmsnorm", x)
        ctx.save_for_backward(s, gain)
        ctx.eps = eps
        return s, h

    @staticmethod
    def backward(ctx, ds, dh):
        s, gain = ctx.saved_tensors
        if dh is None:               # the norm's output was not used
            dx = torch.zeros_like(s) if ds is None else ds
            return dx, dx, torch.zeros_like(gain), None
        dx, dgain = add_rmsnorm_backward(s, ds, dh, gain, ctx.eps)
        return dx, dx, dgain, None


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm of ``x`` over its last axis with per-feature ``gain``; the
    output has ``x``'s shape and dtype.  Differentiable on both devices."""
    refuse_dtensor("rmsnorm", x, gain)
    if stands_in(x, gain):
        return run_stand_in(_RMSNormStandIn(eps), x, gain)
    if x.device.type == "cpu":
        return rmsnorm_reference(x, gain, eps)
    if _needs_grad(x, gain):
        return _RMSNormFunction.apply(x, gain, eps)
    _, out = _forward(x, None, gain, eps)
    if out.numel():
        rmsnorm.launches += 1
        _report("rmsnorm", x)
    return out


def add_rmsnorm(x: torch.Tensor, delta: torch.Tensor | None, gain: torch.Tensor,
                eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s, h)``: the residual sum ``s = x + delta`` (rounded to ``x``'s
    dtype, as ``x + delta`` rounds) and its RMSNorm ``h = rmsnorm(s, gain,
    eps)``, from one launch.  With ``delta`` None, ``s`` is ``x`` itself and
    ``h`` comes from :func:`rmsnorm`.  Differentiable on both devices."""
    refuse_dtensor("add_rmsnorm", x, delta, gain)
    if delta is None:
        return x, rmsnorm(x, gain, eps)
    if stands_in(x, delta, gain):
        return run_stand_in(_AddRMSNormStandIn(eps), x, delta, gain)
    if x.device.type == "cpu":
        return add_rmsnorm_reference(x, delta, gain, eps)
    if _needs_grad(x, delta, gain):
        return _AddRMSNormFunction.apply(x, delta, gain, eps)
    s, h = _forward(x, delta, gain, eps)
    if h.numel():
        add_rmsnorm.launches += 1
        _report("add_rmsnorm", x)
    return s, h


def _check_backward(x, dy, dres, gain) -> int:
    rows = _check(x, gain, dres)
    if dy.device != x.device or dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"dy must match x ({x.device}, {x.dtype}, {tuple(x.shape)}), got "
                         f"{dy.device}, {dy.dtype}, {tuple(dy.shape)}")
    return rows


def _backward(x, dy, dres, gain, eps: float):
    """(dx, dgain) from the backward kernel's two launches, the rows pass
    and the finish; counts nothing."""
    dy = dy.contiguous()
    dres = None if dres is None else dres.contiguous()
    rows = _check_backward(x, dy, dres, gain)
    d = x.shape[-1]
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros(d, dtype=gain.dtype, device=x.device)
    lib = BACKWARD_LIBRARY.load()
    scratch = torch.empty(lib.rmsnorm_bwd_scratch(rows, d), dtype=torch.float32, device=x.device)
    dgain = torch.empty(d, dtype=torch.float32, device=x.device)
    g = _gain32(gain)
    args = (x.data_ptr(), dy.data_ptr(), None if dres is None else dres.data_ptr(), g.data_ptr(),
            dx.data_ptr(), scratch.data_ptr(), dgain.data_ptr(), rows, d, float(eps),
            DTYPES[x.dtype])
    rc = _on_card(lib.rmsnorm_bwd_launch, args, x.get_device())
    if rc != 0:
        raise RuntimeError(f"rmsnorm backward launch failed: CUDA error {rc}")
    return dx, dgain.to(gain.dtype)


def rmsnorm_backward(x: torch.Tensor, dy: torch.Tensor, gain: torch.Tensor,
                     eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients ``(dx, dgain)`` of ``h = rmsnorm(x, gain, eps)`` given
    ``dy = dL/dh`` (``dx`` in ``x``'s dtype, ``dgain`` in ``gain``'s): the
    backward kernel on CUDA tensors, its plain version
    (:func:`~.ref.rmsnorm_backward_reference`) on CPU tensors."""
    refuse_dtensor("rmsnorm_backward", x, dy, gain)
    if stands_in(x, dy, gain):
        cost = norm_backward_cost(_rows(x), x.shape[-1], False, x.element_size())
        return counted("rmsnorm_backward", cost, lambda: filled(
            _grad_buffers(x, gain), lambda: rmsnorm_backward_reference(x, dy, gain, eps),
            is_fake(x, dy, gain)))
    if x.device.type == "cpu":
        return rmsnorm_backward_reference(x, dy, gain, eps)
    out = _backward(x, dy, None, gain, eps)
    if x.numel():
        rmsnorm_backward.launches += 1
        _report("rmsnorm_backward", x)
    return out


def add_rmsnorm_backward(s: torch.Tensor, ds: torch.Tensor | None, dh: torch.Tensor,
                         gain: torch.Tensor, eps: float = 1e-5
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of :func:`add_rmsnorm` from its residual sum ``s`` and
    the gradients ``ds`` (of ``s``, or None) and ``dh`` (of the norm):
    ``(dx, dgain)``, ``dx`` being the gradient of ``x`` and of ``delta``
    alike.  The backward kernel with the residual gradient added in, on
    CUDA tensors; its plain version on CPU tensors."""
    refuse_dtensor("add_rmsnorm_backward", s, ds, dh, gain)
    if stands_in(s, ds, dh, gain):
        cost = norm_backward_cost(_rows(s), s.shape[-1], ds is not None, s.element_size())
        return counted("add_rmsnorm_backward", cost, lambda: filled(
            _grad_buffers(s, gain), lambda: add_rmsnorm_backward_reference(s, ds, dh, gain, eps),
            is_fake(s, ds, dh, gain)))
    if s.device.type == "cpu":
        return add_rmsnorm_backward_reference(s, ds, dh, gain, eps)
    out = _backward(s, dh, ds, gain, eps)
    if s.numel():
        add_rmsnorm_backward.launches += 1
        _report("add_rmsnorm_backward", s, fused=ds is not None)
    return out


#: Kernel launches since the count was last set to 0.
rmsnorm.launches = 0
add_rmsnorm.launches = 0
rmsnorm_backward.launches = 0
add_rmsnorm_backward.launches = 0
