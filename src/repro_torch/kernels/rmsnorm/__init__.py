"""RMSNorm, alone and fused with the residual add before it: CUDA kernel
and plain versions."""
from .ops import add_rmsnorm, rmsnorm
from .ref import add_rmsnorm_reference, rmsnorm_reference

__all__ = ["add_rmsnorm", "add_rmsnorm_reference", "rmsnorm", "rmsnorm_reference"]
