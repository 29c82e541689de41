"""Sparse flow step and per-container sums of the simulator's tick: CUDA
kernels and plain versions."""
from .ops import cluster_size_for, container_sum, index_dtype, stream_flow_ell
from .ref import (
    container_members, container_sum_reference, ell_rows, stream_flow_ell_reference,
    stream_flow_reference,
)

__all__ = [
    "cluster_size_for", "container_members", "container_sum", "container_sum_reference",
    "ell_rows", "index_dtype", "stream_flow_ell", "stream_flow_ell_reference",
    "stream_flow_reference",
]
