"""Mamba selective scan and its backward: CUDA kernels and plain versions."""
from .ops import ssm_scan, ssm_scan_backward, ssm_scan_with_checkpoints
from .ref import ssm_scan_backward_reference, ssm_scan_reference

__all__ = ["ssm_scan", "ssm_scan_backward", "ssm_scan_backward_reference", "ssm_scan_reference",
           "ssm_scan_with_checkpoints"]
