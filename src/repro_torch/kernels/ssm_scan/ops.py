"""The selective scan as the Mamba block calls it, and its backward.

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

Gradients.  On the card, under grad mode with an input that requires
grad, :func:`ssm_scan` goes through a ``torch.autograd.Function`` whose
forward is the same kernel, here also storing the state at the start of
every range of the backward's (``ssm_scan_ckpt_launch``; ``y`` and ``hT``
are the same bits), and whose backward is the hand-written backward
kernel (``csrc/ssm_scan_bwd.cu``), called through
:func:`ssm_scan_backward` with those states; without grad it launches the
forward alone, as serving does, and stores nothing.  On the CPU the plain
version is differentiable as it is.

Counting.  Each launch, forward or backward, reports its FLOPs and bytes
(:mod:`.cost`) to the active counters (:mod:`repro_torch.kernels._cost`).
On ``FakeTensor`` or meta inputs (a dry run), and on CPU inputs while a
counter is active, the wrappers run a stand-in instead: empty outputs and,
under grad, the range-start states the card keeps (a dry run), or the
plain versions, with the same cost reported and no launch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import KernelLibrary, refuse_dtensor
from .._cost import StandIn, add_kernel, counted, filled, is_fake, run_stand_in, stands_in
from .cost import ssm_scan_backward_cost, ssm_scan_cost
from .ref import ssm_scan_backward_reference, ssm_scan_reference

#: Largest state width N the kernel takes (four lanes per channel keep N / 4
#: states each in registers).
MAX_STATE = 16
#: Largest batch (the kernel's grid has one row of blocks per batch row).
MAX_BATCH = 65535
#: Input types the kernel takes, with the code its C entry point expects.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Steps between the states the forward stores under grad (``kCkptSteps``
#: in ``csrc/ssm_scan.cu``; :func:`_checkpoint_shape` checks the library's).
CKPT_STEPS = 8


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssm_scan_launch.argtypes = [ptr] * 8 + [i32] * 4 + [i64] * 4 + [i32, ptr]
    lib.ssm_scan_launch.restype = ctypes.c_int
    lib.ssm_scan_ckpt_launch.argtypes = [ptr] * 9 + [i32] * 4 + [i64] * 4 + [i32, ptr]
    lib.ssm_scan_ckpt_launch.restype = ctypes.c_int
    lib.ssm_scan_ckpt_steps.argtypes = []
    lib.ssm_scan_ckpt_steps.restype = i32


def _bind_backward(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssm_scan_bwd_workspace.argtypes = [i32] * 4
    lib.ssm_scan_bwd_workspace.restype = i64
    lib.ssm_scan_bwd_range_steps.argtypes = []
    lib.ssm_scan_bwd_range_steps.restype = i32
    lib.ssm_scan_bwd_blocks_per_sm.argtypes = []
    lib.ssm_scan_bwd_blocks_per_sm.restype = i32
    lib.ssm_scan_bwd_launch.argtypes = [ptr] * 16 + [i32] * 4 + [i64] * 4 + [i32, ptr]
    lib.ssm_scan_bwd_launch.restype = ctypes.c_int


_CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = KernelLibrary("ssm_scan", _CSRC / "ssm_scan.cu", _bind)
BACKWARD_LIBRARY = KernelLibrary("ssm_scan_bwd", _CSRC / "ssm_scan_bwd.cu", _bind_backward)


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


def _operands(dt, x, bmat, cmat, a, h0):
    """The inputs as the kernels take them: dt and x contiguous, B and C
    with a last stride of 1, a and h0 contiguous fp32."""
    bmat = bmat if bmat.stride(-1) == 1 else bmat.contiguous()
    cmat = cmat if cmat.stride(-1) == 1 else cmat.contiguous()
    return (dt.contiguous(), x.contiguous(), bmat, cmat, a.to(torch.float32).contiguous(),
            h0.to(torch.float32).contiguous())


def _checkpoint_shape(dt, a) -> tuple[int, int, int, int]:
    """The shape (B, R, D, N) of the range-start states the forward stores
    under grad and the backward takes: one every ``ssm_scan_ckpt_steps()``
    steps, the backward's range."""
    B, S, D = dt.shape
    steps = LIBRARY.load().ssm_scan_ckpt_steps()
    if steps != BACKWARD_LIBRARY.load().ssm_scan_bwd_range_steps() or steps != CKPT_STEPS:
        raise RuntimeError("the forward stores states at another interval than the backward's "
                           f"ranges or CKPT_STEPS ({CKPT_STEPS})")
    return B, -(-S // steps), D, a.shape[1]


def _forward(dt, x, bmat, cmat, a, h0, ckpt=None):
    """(y, hT) from one forward launch on CUDA tensors; counts nothing.
    With ``ckpt`` (:func:`_checkpoint_shape`, fp32) the launch also stores
    the range-start states in it."""
    _check(dt, x, bmat, cmat, a, h0)
    B, S, D = dt.shape
    N = a.shape[1]
    dt, x, bmat, cmat, a, h0 = _operands(dt, x, bmat, cmat, a, h0)
    y = torch.empty((B, S, D), dtype=torch.float32, device=dt.device)
    hT = torch.empty((B, D, N), dtype=torch.float32, device=dt.device)
    if B == 0 or D == 0:
        return y, hT
    lib = LIBRARY.load()
    with torch.cuda.device(dt.device):
        args = (B, S, D, N, bmat.stride(0), bmat.stride(1), cmat.stride(0), cmat.stride(1),
                DTYPES[dt.dtype], torch.cuda.current_stream().cuda_stream)
        pointers = (dt.data_ptr(), x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
                    a.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr())
        if ckpt is None:
            rc = lib.ssm_scan_launch(*pointers, *args)
        else:
            _check_ckpt(ckpt, dt, a)
            rc = lib.ssm_scan_ckpt_launch(*pointers, ckpt.data_ptr(), *args)
    if rc != 0:
        raise RuntimeError(f"ssm_scan launch failed: CUDA error {rc}")
    return y, hT


def _check_ckpt(ckpt, dt, a) -> None:
    shape = _checkpoint_shape(dt, a)
    if (tuple(ckpt.shape) != shape or ckpt.dtype != torch.float32 or ckpt.device != dt.device
            or not ckpt.is_contiguous()):
        raise ValueError(f"ckpt must be a contiguous {shape} float32 tensor on {dt.device}, got "
                         f"{ckpt.dtype} {tuple(ckpt.shape)} on {ckpt.device}")


def _cost(dt, a, ckpt: bool) -> tuple[int, int]:
    """``(flops, bytes)`` of one forward launch on these inputs."""
    B, S, D = dt.shape
    return ssm_scan_cost(B, S, D, a.shape[1], dt.element_size(), CKPT_STEPS if ckpt else 0)


def _backward_cost(dt, a) -> tuple[int, int]:
    """``(flops, bytes)`` of one backward launch on these inputs."""
    B, S, D = dt.shape
    return ssm_scan_backward_cost(B, S, D, a.shape[1], dt.element_size())


def _launched(dt) -> bool:
    return bool(dt.shape[0] and dt.shape[2])


def _grad_buffers(inputs: tuple) -> tuple:
    """The gradients of ``(dt, x, bmat, cmat, a, h0)`` as the backward
    wrapper allocates them (each contiguous, in its input's dtype)."""
    return tuple(t.new_empty(t.shape) for t in inputs)


class _ScanStandIn(StandIn):
    """:func:`ssm_scan` in a count: empty outputs and, under grad, the
    range-start states the card keeps, on fake inputs; the plain versions
    on real ones."""

    name, backward_name = "ssm_scan", "ssm_scan_backward"

    def outputs(self, inputs, grad):
        dt, a = inputs[0], inputs[4]
        fake = is_fake(*inputs)
        B, S, D = dt.shape
        N = a.shape[1]
        kept = ((dt.new_empty((B, -(-S // CKPT_STEPS), D, N), dtype=torch.float32),)
                if fake and grad else ())
        return filled((dt.new_empty((B, S, D), dtype=torch.float32),
                       dt.new_empty((B, D, N), dtype=torch.float32)),
                      lambda: ssm_scan_reference(*inputs), fake), kept

    def cost(self, inputs, grad):
        return _cost(inputs[0], inputs[4], grad)

    def gradients(self, inputs, outputs, kept, grads):
        dy, dhT = grads
        dt = inputs[0]
        if dy is None:
            dy = dt.new_zeros(dt.shape, dtype=torch.float32)
        out = filled(_grad_buffers(inputs), lambda: ssm_scan_backward_reference(*inputs, dy, dhT),
                     is_fake(*inputs))
        return out, _backward_cost(dt, inputs[4])


class _SSMScanFunction(torch.autograd.Function):
    """:func:`ssm_scan` on the card under grad: the forward kernel, storing
    the range-start states beside y and hT, then :func:`ssm_scan_backward`'s
    kernels, which recompute the states of each range from them."""

    @staticmethod
    def forward(ctx, dt, x, bmat, cmat, a, h0):
        ctx.set_materialize_grads(False)
        ckpt = torch.empty(_checkpoint_shape(dt, a), dtype=torch.float32, device=dt.device)
        y, hT = _forward(dt, x, bmat, cmat, a, h0, ckpt=ckpt)
        if _launched(dt):
            ssm_scan.launches += 1
            add_kernel("ssm_scan", _cost, dt, a, True)
        ctx.save_for_backward(dt, x, bmat, cmat, a, h0, ckpt)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        dt, x, bmat, cmat, a, h0, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(dt.shape, dtype=torch.float32, device=dt.device)
        return ssm_scan_backward(dt, x, bmat, cmat, a, h0, dy, dhT, ckpt=ckpt)


def ssm_scan(dt, x, bmat, cmat, a, h0):
    """The selective scan of ``x`` with step sizes ``dt`` (B, S, D), input
    and output projections ``bmat`` and ``cmat`` (B, S, N), decay ``a``
    (D, N, negative) and initial state ``h0`` (B, D, N).  Returns
    (y (B, S, D), hT (B, D, N)), both fp32.  Differentiable on both
    devices: on the card under grad the backward kernel computes the
    gradients."""
    refuse_dtensor("ssm_scan", dt, x, bmat, cmat, a, h0)
    if stands_in(dt, x, bmat, cmat, a, h0):
        return run_stand_in(_ScanStandIn(), dt, x, bmat, cmat, a, h0)
    if dt.device.type == "cpu":
        return ssm_scan_reference(dt, x, bmat, cmat, a, h0)
    if dt.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu, not {dt.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (dt, x, bmat, cmat, a, h0)):
        return _SSMScanFunction.apply(dt, x, bmat, cmat, a, h0)
    y, hT = _forward(dt, x, bmat, cmat, a, h0)
    if _launched(dt):
        ssm_scan.launches += 1
        add_kernel("ssm_scan", _cost, dt, a, False)
    return y, hT


def ssm_scan_with_checkpoints(dt, x, bmat, cmat, a, h0):
    """``(y, hT, ckpt)`` on CUDA tensors: one launch of the forward kernel
    as the autograd Function runs it, ``y`` and ``hT`` the same bits as
    :func:`ssm_scan`'s and ``ckpt`` the range-start states
    (:func:`_checkpoint_shape`, fp32) as :func:`ssm_scan_backward` takes
    them.  Counts one forward launch."""
    refuse_dtensor("ssm_scan_with_checkpoints", dt, x, bmat, cmat, a, h0)
    if dt.device.type != "cuda":
        raise ValueError(f"ssm_scan_with_checkpoints runs on cuda, not {dt.device}")
    _check(dt, x, bmat, cmat, a, h0)
    ckpt = torch.empty(_checkpoint_shape(dt, a), dtype=torch.float32, device=dt.device)
    y, hT = _forward(dt, x, bmat, cmat, a, h0, ckpt=ckpt)
    if _launched(dt):
        ssm_scan.launches += 1
        add_kernel("ssm_scan", _cost, dt, a, True)
    return y, hT, ckpt


def ssm_scan_backward(dt, x, bmat, cmat, a, h0, dy, dhT=None, ckpt=None):
    """The gradients ``(ddt, dx, dB, dC, dA, dh0)`` of ``(y, hT) =
    ssm_scan(dt, x, bmat, cmat, a, h0)`` given ``dy = dL/dy`` (B, S, D)
    and ``dhT = dL/dhT`` (B, D, N, or None), each in its input's dtype: the
    backward kernel's two launches (the scan backward, then the fixed-order
    finish of the sums over channels and batch rows) on CUDA tensors, its
    plain version (:func:`~.ref.ssm_scan_backward_reference`) on CPU
    tensors.  ``ckpt`` is the forward's range-start states, as
    :func:`ssm_scan_with_checkpoints` (or the autograd Function) gives
    them; without it the wrapper runs that forward launch first (counted in
    ``ssm_scan.launches``).  The plain version recomputes every state."""
    refuse_dtensor("ssm_scan_backward", dt, x, bmat, cmat, a, h0, dy, dhT, ckpt)
    if stands_in(dt, x, bmat, cmat, a, h0, dy):
        inputs = (dt, x, bmat, cmat, a, h0)
        return counted("ssm_scan_backward", _backward_cost(dt, a), lambda: filled(
            _grad_buffers(inputs), lambda: ssm_scan_backward_reference(*inputs, dy, dhT),
            is_fake(*inputs, dy)))
    if dt.device.type == "cpu":
        return ssm_scan_backward_reference(dt, x, bmat, cmat, a, h0, dy, dhT)
    if dt.device.type != "cuda":
        raise ValueError(f"ssm_scan_backward runs on cuda or cpu, not {dt.device}")
    _check(dt, x, bmat, cmat, a, h0)
    B, S, D = dt.shape
    N = a.shape[1]
    for name, t, shape in (("dy", dy, (B, S, D)), ("dhT", dhT, (B, D, N))):
        if t is not None and (tuple(t.shape) != shape or t.device != dt.device):
            raise ValueError(f"{name} must be {shape} on {dt.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    dtp, xp, bp, cp, a32, h32 = _operands(dt, x, bmat, cmat, a, h0)
    dy = dy.to(torch.float32).contiguous()
    dhT = None if dhT is None else dhT.to(torch.float32).contiguous()
    ddt, dx = torch.empty_like(dtp), torch.empty_like(xp)
    db = torch.empty((B, S, N), dtype=dt.dtype, device=dt.device)
    dc = torch.empty_like(db)
    da = torch.empty((D, N), dtype=torch.float32, device=dt.device)
    dh0 = torch.empty((B, D, N), dtype=torch.float32, device=dt.device)
    if B == 0 or D == 0:
        return ddt, dx, db.zero_(), dc.zero_(), da.zero_().to(a.dtype), dh0.to(h0.dtype)
    lib = BACKWARD_LIBRARY.load()
    inputs = (dtp.data_ptr(), xp.data_ptr(), bp.data_ptr(), cp.data_ptr(), a32.data_ptr(),
              h32.data_ptr(), dy.data_ptr(), None if dhT is None else dhT.data_ptr())
    outputs = (ddt.data_ptr(), dx.data_ptr(), db.data_ptr(), dc.data_ptr(), da.data_ptr(),
               dh0.data_ptr())
    if ckpt is None:
        ckpt = ssm_scan_with_checkpoints(dt, x, bmat, cmat, a, h0)[2]
    _check_ckpt(ckpt, dt, a)
    work = torch.empty(lib.ssm_scan_bwd_workspace(B, S, D, N), dtype=torch.float32,
                       device=dt.device)
    with torch.cuda.device(dt.device):
        rc = lib.ssm_scan_bwd_launch(
            *inputs, ckpt.data_ptr(), *outputs, work.data_ptr(), B, S, D, N, bp.stride(0),
            bp.stride(1), cp.stride(0), cp.stride(1), DTYPES[dt.dtype],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan backward launch failed: CUDA error {rc}")
    ssm_scan_backward.launches += 1
    add_kernel("ssm_scan_backward", _backward_cost, dt, a)
    return ddt, dx, db, dc, da.to(a.dtype), dh0.to(h0.dtype)


#: Kernel launches since the count was last set to 0.
ssm_scan.launches = 0
ssm_scan_backward.launches = 0
