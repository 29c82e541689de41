"""What a hand-written kernel's call costs, and the stand-in a count runs in
its place.

A counter (:class:`repro_torch.launch.counting.StepCounter`) registers
here while it counts a step.  Every kernel wrapper reports each launch to
it (:func:`add_kernel`) with the kernel's FLOPs and bytes, computed from
the shapes by the formulas in the kernel's package (``cost.py``, the same
that give ``chip_smoke.py``'s bounds): on the card where it launches, and
in a stand-in where it does not.

A stand-in (:class:`StandIn`, run by :func:`run_stand_in`) takes a
wrapper's place in two cases.  On ``FakeTensor`` or meta inputs (a dry
run) it returns empty outputs of the kernel's shapes and dtypes, and under
grad keeps what the card's autograd Function keeps (flash's row
statistics, the scan's checkpoints) and returns empty gradients.  On real
CPU inputs while a counter is active it runs the kernel's plain version
and, under grad, its written-out plain backward, with the ops they
dispatch left out of the count (:func:`quiet`, in :func:`filled`); the
buffers it fills are allocated as the wrapper on the card allocates them.
Either way it reports the kernel's own cost, as a launch would, and
neither launches nor touches ``.launches``.  So a dry run, a counted step
on gloo ranks and a counted step on the card count the same kernels the
same way.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_LOCK = threading.Lock()
_COUNTERS: list = []
_QUIET = [0]


def add_kernel(name: str, cost, *args) -> None:
    """Reports one launch of kernel ``name`` to every registered counter,
    ``cost(*args)`` its ``(flops, bytes)``: worked out only while a counter
    is registered, so an uncounted launch pays nothing for it."""
    if not _COUNTERS:
        return
    flops, nbytes = cost(*args)
    for counter in list(_COUNTERS):
        counter.kernel(name, flops, nbytes)


def counting() -> bool:
    """Whether a counter is registered."""
    return bool(_COUNTERS)


def is_quiet() -> bool:
    """Whether ops dispatched now stand in for a kernel (not counted)."""
    return _QUIET[0] > 0


@contextlib.contextmanager
def quiet():
    """The ops dispatched inside stand in for work a step on the card does
    not dispatch (a kernel's plain version; a table the card finds cached):
    counters leave their FLOPs, bytes and collectives out (their memory
    still counts)."""
    with _LOCK:
        _QUIET[0] += 1
    try:
        yield
    finally:
        with _LOCK:
            _QUIET[0] -= 1


@contextlib.contextmanager
def registered(counter):
    """``counter`` receives every kernel launch reported inside."""
    with _LOCK:
        _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        with _LOCK:
            _COUNTERS.remove(counter)


def is_fake(*tensors) -> bool:
    """Whether any of ``tensors`` is a ``FakeTensor`` or on the meta device:
    data a dry run shapes but never holds."""
    from torch._subclasses.fake_tensor import FakeTensor

    return any(t is not None and (isinstance(t, FakeTensor) or t.is_meta) for t in tensors)


def stands_in(*tensors) -> bool:
    """Whether a wrapper given ``tensors`` runs its stand-in: fake or meta
    inputs, or CPU inputs while a counter is active."""
    first = next(t for t in tensors if t is not None)
    return is_fake(*tensors) or (first.device.type == "cpu" and counting())


class StandIn:
    """One kernel's call as a count takes it.  A subclass sets ``name`` and
    ``backward_name`` (the counters' keys) and defines :meth:`outputs`,
    :meth:`cost` and, for a kernel with a backward, :meth:`gradients`."""

    name = ""
    backward_name = ""

    def outputs(self, inputs: tuple, grad: bool) -> tuple[tuple, tuple]:
        """``(outputs, kept)``: the kernel's outputs for ``inputs`` and, under
        grad (``grad``), what its autograd Function keeps beside them."""
        raise NotImplementedError

    def cost(self, inputs: tuple, grad: bool) -> tuple[float, float]:
        """``(flops, bytes)`` of the forward launch."""
        raise NotImplementedError

    def gradients(self, inputs: tuple, outputs: tuple, kept: tuple, grads: tuple
                  ) -> tuple[tuple, tuple[float, float] | None]:
        """``(input gradients, (flops, bytes) of the backward launch or None
        where the card launches none)`` given the outputs' gradients
        ``grads`` (None for an unused output)."""
        raise NotImplementedError


class _StandInFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel: StandIn, *inputs):
        ctx.set_materialize_grads(False)
        outs, kept = kernel.outputs(inputs, True)
        add_kernel(kernel.name, kernel.cost, inputs, True)
        ctx.kernel, ctx.sizes = kernel, (len(inputs), len(outs))
        ctx.save_for_backward(*inputs, *outs, *kept)
        return outs if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        n_in, n_out = ctx.sizes
        inputs, outs, kept = saved[:n_in], saved[n_in:n_in + n_out], saved[n_in + n_out:]
        gin, cost = ctx.kernel.gradients(inputs, outs, kept, grads)
        if cost is not None:
            add_kernel(ctx.kernel.backward_name, lambda: cost)
        return (None, *gin)


def run_stand_in(kernel: StandIn, *inputs):
    """``kernel``'s outputs for ``inputs`` (one tensor or a tuple), its cost
    reported as one launch; under grad with an input that requires it,
    through an autograd Function whose backward reports the backward
    kernel's launch."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _StandInFunction.apply(kernel, *inputs)
    with torch.no_grad():
        outs, _ = kernel.outputs(inputs, False)
    add_kernel(kernel.name, kernel.cost, inputs, False)
    return outs if len(outs) > 1 else outs[0]


def counted(name: str, cost: tuple[float, float], make):
    """``make()`` (a :func:`filled` call) standing in for one launch of
    kernel ``name``, ``cost`` (flops, bytes) reported."""
    out = make()
    add_kernel(name, lambda: cost)
    return out


def filled(buffers: tuple, make, fake: bool) -> tuple:
    """``buffers`` (a kernel's outputs as its wrapper allocates them on the
    card) holding ``make()``'s values (the plain version's), or left empty
    on fake inputs: a stand-in's outputs keep the kernel's layout, so the
    ops after it run as after a launch.  The plain version's ops and the
    copies are left out of the count (:func:`quiet`)."""
    if not fake:
        with quiet():
            for buf, value in zip(buffers, make()):
                buf.copy_(value)
    return buffers
