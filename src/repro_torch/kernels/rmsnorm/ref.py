"""Plain PyTorch versions of the RMSNorm kernels: the contract of the
reference package's ``kernels/rmsnorm/ref.py::rmsnorm_reference``, and the
same norm after the residual add in front of it."""
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
