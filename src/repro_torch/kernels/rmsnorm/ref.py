"""Plain PyTorch versions of the RMSNorm kernels: the contract of the
reference package's ``kernels/rmsnorm/ref.py::rmsnorm_reference``, the
same norm after the residual add in front of it, and the backward of both
written out (held to autograd through the forward ones)."""
from __future__ import annotations

import torch


def rmsnorm_reference(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · gain`` over the last axis, in fp32,
    cast back to ``x``'s dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (y * gain.float()).to(x.dtype)


def add_rmsnorm_reference(x: torch.Tensor, delta: torch.Tensor | None, gain: torch.Tensor,
                          eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s, rmsnorm_reference(s))`` with ``s = x + delta`` (``x`` itself
    when ``delta`` is None)."""
    s = x if delta is None else x + delta
    return s, rmsnorm_reference(s, gain, eps)


def rmsnorm_backward_reference(x: torch.Tensor, dy: torch.Tensor, gain: torch.Tensor,
                               eps: float = 1e-5, dres: torch.Tensor | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``h = rmsnorm_reference(x, gain, eps)`` given ``dy
    = dL/dh``, written out: per row, in fp32, ``inv = rsqrt(mean(x²) +
    eps)``, ``dx = inv·(gain⊙dy) − x·inv³·mean(x⊙gain⊙dy)``, cast to ``x``'s
    dtype; ``dgain`` the sum over rows of ``dy⊙x·inv``, in ``gain``'s dtype.
    ``dres``, a gradient reaching ``x`` by another path (the residual sum's
    own), is added to ``dx`` in ``x``'s dtype, as autograd adds two
    gradients of one tensor.  Returns (dx, dgain)."""
    x32, dy32, g = x.float(), dy.float(), gain.float()
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    gdy = g * dy32
    dx = (inv * gdy - x32 * inv ** 3 * (x32 * gdy).mean(dim=-1, keepdim=True)).to(x.dtype)
    if dres is not None:
        dx = dx + dres
    dgain = (dy32 * (x32 * inv)).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx, dgain.to(gain.dtype)


def add_rmsnorm_backward_reference(s: torch.Tensor, ds: torch.Tensor | None, dh: torch.Tensor,
                                   gain: torch.Tensor, eps: float = 1e-5
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of :func:`add_rmsnorm_reference` from its residual sum
    ``s = x + delta`` and the gradients of its two outputs, ``ds`` (of
    ``s``; None when ``s`` is not used further) and ``dh`` (of the norm):
    ``(dx, dgain)``, where ``dx`` is the gradient of ``x`` and of
    ``delta`` alike."""
    return rmsnorm_backward_reference(s, dh, gain, eps, dres=ds)
