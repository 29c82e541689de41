"""RMSNorm: CUDA kernel and plain version."""
from .ops import rmsnorm
from .ref import rmsnorm_reference

__all__ = ["rmsnorm", "rmsnorm_reference"]
