"""Plain PyTorch version of the RMSNorm kernel: the contract of the
reference package's ``kernels/rmsnorm/ref.py::rmsnorm_reference``."""
from __future__ import annotations

import torch


def rmsnorm_reference(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · gain`` over the last axis, in fp32,
    cast back to ``x``'s dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (y * gain.float()).to(x.dtype)
