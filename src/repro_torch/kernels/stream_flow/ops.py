"""The sparse flow step and the per-container sums as the simulator calls
them.

:func:`stream_flow_ell` and :func:`container_sum` run the hand-written CUDA
kernels (``csrc/stream_flow.cu``) on CUDA tensors and their plain PyTorch
versions (:func:`~.ref.stream_flow_ell_reference`,
:func:`~.ref.container_sum_reference`) on CPU tensors.  A CUDA input
either launches the kernel or raises; there is no fallback.

The flow-step kernel replaces the reference package's Pallas TPU kernels
``kernels/stream_flow/stream_flow.py:_demand_kernel`` / ``:_flow_kernel``;
the per-container sums replace the reference simulator's plain ``x @ C``
one-hot products (``streams/simulator.py``), which are no Pallas kernel.
The flow step is bound by bytes (the real ELL slots and the per-edge
arrays they index); see the note at the top of the CUDA source for what its
design does about that.  Each batch row runs on one thread-block cluster, so the kernel
needs a card with thread-block clusters (``sm_90a``, Hopper).
"""
from __future__ import annotations

import functools
import math

import torch

from . import build
from .ref import container_members, container_sum_reference, stream_flow_ell_reference

#: Shared memory one block may use on an H100 (opted in above 48 KB).  Each
#: CTA holds (4 I + 2 K + 1) words, so the largest row is, for example,
#: I = 11,264 instances with K = 5,632 containers (225,284 bytes).
SMEM_LIMIT_BYTES = 232_448
#: Largest cluster the kernel launches (above 8 CTAs needs the non-portable
#: opt-in, which the launch sets).
MAX_CLUSTER = 16
#: Fewest instances a CTA of a cluster larger than one owns: below that a
#: CTA's warps would outnumber its ELL rows.
MIN_SLICE = 64
#: Threads per CTA at most (one warp per ELL row it walks).
MAX_THREADS = 1024


def index_dtype(device: torch.device) -> torch.dtype:
    """Index type the flow step takes on ``device``: int32 for the kernel
    (half the bytes), int64 on the CPU (what torch's gathers index with), so
    staging casts once and the tick never does."""
    return torch.int32 if torch.device(device).type == "cuda" else torch.int64


def cluster_size_for(batch: int, n_inst: int, n_sms: int = 132) -> int:
    """CTAs per batch row: the smallest power of two that puts a CTA on
    every SM (``batch · n >= n_sms``), at most :data:`MAX_CLUSTER`, and no
    more than leaves each CTA :data:`MIN_SLICE` instances."""
    n = 1
    while n < MAX_CLUSTER and batch * n < n_sms and n_inst >= MIN_SLICE * 2 * n:
        n *= 2
    return n


def threads_for(n_inst: int, cluster: int) -> int:
    """Threads per CTA: one warp per instance of the CTA's slice, up to
    :data:`MAX_THREADS`."""
    return 32 * min(MAX_THREADS // 32, math.ceil(n_inst / cluster))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(qout, edge_arrays, ell_src, ell_dst, cont_of, sm_budget, cont_ptr,
           cont_members) -> None:
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
        "cont_ptr": (cont_ptr, torch.int32, (B, K + 1)),
        "cont_members": (cont_members, torch.int32, (B, I)),
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
    if B > 65535:
        raise ValueError(f"at most 65535 rows per launch, got {B}")


def stream_flow_ell(
    qout, edge_src, edge_share, edge_remote, edge_src_cont, edge_dst_cont,
    ell_src, ell_dst, cont_of, sm_budget, cont_ptr=None, cont_members=None,
    *, cluster_size=None,
):
    """One sparse flow step for a batch of rows: ``(delivered, arrivals,
    trav_c)``.  Arguments as :func:`~.ref.stream_flow_ell_reference`.

    ``cont_ptr``/``cont_members`` are the member lists of
    :func:`~.ref.container_members`, which the kernel sums containers
    through; a caller that runs many steps builds them once and passes
    them, else they are built here for this call.  The plain version
    ignores them.

    Precondition of the kernel: each ELL row lists its real edge ids (those
    ``< E``) first and its padding after them (:func:`~.ref.ell_rows`'s
    layout).  A warp stops reading a row at its first chunk of 32 slots
    that holds a padding id, so a real id after the padding is not summed.

    The kernel runs each row on a cluster of :func:`cluster_size_for` CTAs,
    each with the whole row in shared memory: a row of I instances and K
    containers needs (4 I + 2 K + 1)·4 bytes per CTA at any cluster size,
    and one over :data:`SMEM_LIMIT_BYTES` raises.  ``cluster_size`` forces
    the cluster size, for tests only: the results are bit for bit the same
    at every size.
    """
    if qout.device.type == "cpu":
        return stream_flow_ell_reference(
            qout, edge_src, edge_share, edge_remote, edge_src_cont,
            edge_dst_cont, ell_src, ell_dst, cont_of, sm_budget,
        )
    if qout.device.type != "cuda":
        raise ValueError(f"stream_flow_ell runs on cuda or cpu, not {qout.device}")
    if qout.dim() != 2 or sm_budget.dim() != 2:
        raise ValueError("qout must be (B, I) and sm_budget (B, K)")
    if (cont_ptr is None) != (cont_members is None):
        raise ValueError("pass both cont_ptr and cont_members, or neither")
    if cont_ptr is None:
        cont_ptr, cont_members = container_members(cont_of, sm_budget.shape[1])
    edges = (edge_src, edge_share, edge_remote, edge_src_cont, edge_dst_cont)
    _check(qout, edges, ell_src, ell_dst, cont_of, sm_budget, cont_ptr, cont_members)
    B, I = qout.shape
    K = sm_budget.shape[1]
    E = edge_src.shape[1]
    lib = build.load()
    smem = lib.stream_flow_ell_smem_bytes(I, K)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"a row of {I} instances and {K} containers needs {smem} bytes of "
            f"shared memory per CTA, over the {SMEM_LIMIT_BYTES}-byte limit"
        )
    if cluster_size is None:
        cluster_size = cluster_size_for(B, I, _sm_count(qout.device.index or 0))
    elif not 1 <= cluster_size <= MAX_CLUSTER:
        raise ValueError(f"cluster_size must be in 1..{MAX_CLUSTER}, got {cluster_size}")
    threads = threads_for(I, cluster_size)
    delivered = torch.empty_like(qout)
    arrivals = torch.empty_like(qout)
    trav_c = torch.empty_like(sm_budget)
    with torch.cuda.device(qout.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stream_flow_ell_launch(
            qout.data_ptr(), edge_src.data_ptr(), edge_share.data_ptr(),
            edge_remote.data_ptr(), edge_src_cont.data_ptr(),
            edge_dst_cont.data_ptr(), ell_src.data_ptr(), ell_dst.data_ptr(),
            cont_ptr.data_ptr(), cont_members.data_ptr(), sm_budget.data_ptr(),
            delivered.data_ptr(), arrivals.data_ptr(), trav_c.data_ptr(),
            B, I, K, E, ell_src.shape[2], ell_dst.shape[2], cluster_size,
            threads, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"stream_flow_ell launch failed (cluster of {cluster_size} CTAs x "
            f"{threads} threads, {smem} bytes of shared memory each): "
            f"{lib.stream_flow_ell_error_string(rc).decode()} ({rc})"
        )
    stream_flow_ell.launches += 1
    return delivered, arrivals, trav_c


#: Kernel launches since the count was last set to 0.
stream_flow_ell.launches = 0


def check_member_lists(cont_ptr, cont_members, batch: int, n_inst: int, device) -> None:
    """Raise unless ``cont_ptr`` (B, K + 1) and ``cont_members`` (B, I) are
    member lists :func:`container_sum`'s kernel takes for ``batch`` rows of
    ``n_inst`` instances on ``device``: int32, contiguous, on the device,
    and a row small enough for the kernel's shared memory.  A caller that
    sums through the same lists many times (the simulator, once per run)
    checks them here once and passes ``checked=True``."""
    n_cont = cont_ptr.shape[-1] - 1
    for name, t, shape in (("cont_ptr", cont_ptr, (batch, n_cont + 1)),
                           ("cont_members", cont_members, (batch, n_inst))):
        if t.device != torch.device(device):
            raise ValueError(f"{name} is on {t.device}, vals on {device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be torch.int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if batch * max(n_inst, n_cont + 1) >= 2**31:
        raise ValueError("vals or member lists too large for the kernel's int32 counts")
    smem = build.load().container_sum_smem_bytes(n_inst)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"a row of {n_inst} instances needs {smem} bytes of shared memory, over the "
            f"{SMEM_LIMIT_BYTES}-byte limit"
        )


def container_sum(vals, cont_of, cont_ptr, cont_members, *, checked: bool = False):
    """(B, I) fp32 per-instance values summed onto (B, K) containers, each
    container's members in instance order (bit for bit
    :func:`~.ref.container_sum_reference`).  ``cont_of`` (B, I) is what the
    plain version reads; ``cont_ptr`` (B, K + 1) and ``cont_members`` (B, I)
    are the member lists of :func:`~.ref.container_members`, built once per
    run, which the kernel walks (int32 on the card).  The kernel holds a
    row's I values in shared memory, so I is at most 58,112.
    ``checked=True`` says :func:`check_member_lists` has passed these lists
    for this (B, I) on this device; only ``vals`` is checked then."""
    n_cont = cont_ptr.shape[1] - 1
    if vals.device.type == "cpu":
        return container_sum_reference(vals, cont_of, n_cont)
    if vals.device.type != "cuda":
        raise ValueError(f"container_sum runs on cuda or cpu, not {vals.device}")
    if vals.dim() != 2:
        raise ValueError(f"vals must be (B, I), got {tuple(vals.shape)}")
    if vals.dtype != torch.float32:
        raise ValueError(f"vals must be torch.float32, got {vals.dtype}")
    if not vals.is_contiguous():
        raise ValueError("vals must be contiguous")
    B, I = vals.shape
    if not checked:
        check_member_lists(cont_ptr, cont_members, B, I, vals.device)
    elif cont_members.shape != vals.shape:
        raise ValueError(f"vals is {tuple(vals.shape)}, the member lists "
                         f"{tuple(cont_members.shape)}")
    lib = build.load()
    out = torch.empty((B, n_cont), dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        rc = lib.container_sum_launch(
            vals.data_ptr(), cont_ptr.data_ptr(), cont_members.data_ptr(),
            out.data_ptr(), B, I, n_cont, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"container_sum launch failed: {lib.stream_flow_ell_error_string(rc).decode()} ({rc})"
        )
    container_sum.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
container_sum.launches = 0
