"""RMSNorm, alone and fused with the residual add before it, and the
backward of both: CUDA kernels and plain versions."""
from .ops import add_rmsnorm, add_rmsnorm_backward, rmsnorm, rmsnorm_backward
from .ref import (
    add_rmsnorm_backward_reference,
    add_rmsnorm_reference,
    rmsnorm_backward_reference,
    rmsnorm_reference,
)

__all__ = ["add_rmsnorm", "add_rmsnorm_backward", "add_rmsnorm_backward_reference",
           "add_rmsnorm_reference", "rmsnorm", "rmsnorm_backward",
           "rmsnorm_backward_reference", "rmsnorm_reference"]
