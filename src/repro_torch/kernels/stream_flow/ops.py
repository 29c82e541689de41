"""The sparse flow step as the simulator calls it.

:func:`stream_flow_ell` runs the hand-written CUDA kernel
(``csrc/stream_flow.cu``) on CUDA tensors and its plain PyTorch version
(:func:`~.ref.stream_flow_ell_reference`) on CPU tensors.  A CUDA input
either launches the kernel or raises; there is no fallback.

The kernel replaces the reference package's Pallas TPU kernels
``kernels/stream_flow/stream_flow.py:_demand_kernel`` / ``:_flow_kernel``.
It is bound by bytes (the ELL rows and per-edge arrays, read once per
pass); see the note at the top of the CUDA source for what its design does
about that.
"""
from __future__ import annotations

import torch

from . import build
from .ref import stream_flow_ell_reference

#: Shared memory a block may use without opting in to the larger carve-out.
SMEM_LIMIT_BYTES = 48 * 1024


def index_dtype(device: torch.device) -> torch.dtype:
    """Index type the flow step takes on ``device``: int32 for the kernel
    (half the bytes), int64 on the CPU (what torch's gathers index with), so
    staging casts once and the tick never does."""
    return torch.int32 if torch.device(device).type == "cuda" else torch.int64


def _check(qout, edge_arrays, ell_src, ell_dst, cont_of, sm_budget) -> None:
    B, I = qout.shape
    K = sm_budget.shape[1]
    E = edge_arrays[0].shape[1]
    expect = {
        "qout": (qout, torch.float32, (B, I)),
        "edge_src": (edge_arrays[0], torch.int32, (B, E)),
        "edge_share": (edge_arrays[1], torch.float32, (B, E)),
        "edge_remote": (edge_arrays[2], torch.float32, (B, E)),
        "edge_src_cont": (edge_arrays[3], torch.int32, (B, E)),
        "edge_dst_cont": (edge_arrays[4], torch.int32, (B, E)),
        "ell_src": (ell_src, torch.int32, (B, I, ell_src.shape[-1])),
        "ell_dst": (ell_dst, torch.int32, (B, I, ell_dst.shape[-1])),
        "cont_of": (cont_of, torch.int32, (B, I)),
        "sm_budget": (sm_budget, torch.float32, (B, K)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != qout.device:
            raise ValueError(f"{name} is on {t.device}, qout on {qout.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(E, I * max(ell_src.shape[-1], ell_dst.shape[-1])) >= 2**31:
        raise ValueError("edge or ELL arrays too large for int32 offsets")


def stream_flow_ell(
    qout, edge_src, edge_share, edge_remote, edge_src_cont, edge_dst_cont,
    ell_src, ell_dst, cont_of, sm_budget, C=None,
):
    """One sparse flow step for a batch of rows: ``(delivered, arrivals,
    trav_c)``.  Arguments as :func:`~.ref.stream_flow_ell_reference`; ``C``
    (the one-hot container membership) is used only by the plain version.
    """
    if qout.device.type == "cpu":
        return stream_flow_ell_reference(
            qout, edge_src, edge_share, edge_remote, edge_src_cont,
            edge_dst_cont, ell_src, ell_dst, cont_of, sm_budget, C,
        )
    if qout.device.type != "cuda":
        raise ValueError(f"stream_flow_ell runs on cuda or cpu, not {qout.device}")
    if qout.dim() != 2 or sm_budget.dim() != 2:
        raise ValueError("qout must be (B, I) and sm_budget (B, K)")
    edges = (edge_src, edge_share, edge_remote, edge_src_cont, edge_dst_cont)
    _check(qout, edges, ell_src, ell_dst, cont_of, sm_budget)
    B, I = qout.shape
    K = sm_budget.shape[1]
    E = edge_src.shape[1]
    lib = build.load()
    smem = lib.stream_flow_ell_smem_bytes(I, K)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"a row of {I} instances and {K} containers needs {smem} bytes of "
            f"shared memory, over the {SMEM_LIMIT_BYTES}-byte limit"
        )
    delivered = torch.empty_like(qout)
    arrivals = torch.empty_like(qout)
    trav_c = torch.empty_like(sm_budget)
    with torch.cuda.device(qout.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stream_flow_ell_launch(
            qout.data_ptr(), edge_src.data_ptr(), edge_share.data_ptr(),
            edge_remote.data_ptr(), edge_src_cont.data_ptr(),
            edge_dst_cont.data_ptr(), ell_src.data_ptr(), ell_dst.data_ptr(),
            cont_of.data_ptr(), sm_budget.data_ptr(), delivered.data_ptr(),
            arrivals.data_ptr(), trav_c.data_ptr(),
            B, I, K, E, ell_src.shape[2], ell_dst.shape[2], stream,
        )
    if rc != 0:
        raise RuntimeError(f"stream_flow_ell launch failed: CUDA error {rc}")
    stream_flow_ell.launches += 1
    return delivered, arrivals, trav_c


#: Kernel launches since the count was last set to 0.
stream_flow_ell.launches = 0
