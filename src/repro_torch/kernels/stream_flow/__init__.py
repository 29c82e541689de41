"""Sparse flow step, per-container sums and fixed-order axis sums of the
simulator's tick: CUDA kernels and plain versions."""
from .ops import cluster_size_for, container_sum, index_dtype, ordered_sum, stream_flow_ell
from .ref import (
    container_members, container_sum_reference, ell_rows, ordered_sum_reference,
    stream_flow_ell_reference, stream_flow_reference,
)

__all__ = [
    "cluster_size_for", "container_members", "container_sum", "container_sum_reference",
    "ell_rows", "index_dtype", "ordered_sum", "ordered_sum_reference", "stream_flow_ell",
    "stream_flow_ell_reference", "stream_flow_reference",
]
