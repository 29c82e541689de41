"""Sparse flow step of the simulator's tick: CUDA kernel and plain versions."""
from .ops import cluster_size_for, index_dtype, stream_flow_ell
from .ref import (
    container_members, ell_rows, stream_flow_ell_reference, stream_flow_reference,
)

__all__ = [
    "cluster_size_for", "container_members", "ell_rows", "index_dtype",
    "stream_flow_ell", "stream_flow_ell_reference", "stream_flow_reference",
]
