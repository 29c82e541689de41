"""Mamba selective scan: CUDA kernel and plain version."""
from .ops import ssm_scan
from .ref import ssm_scan_reference

__all__ = ["ssm_scan", "ssm_scan_reference"]
