"""Plain PyTorch versions of the sparse flow step — the contracts the CUDA
kernel (``csrc/stream_flow.cu``) is held to.

One flow step is the per-tick stream-manager transfer of the sparse tick
(reference ``streams/simulator.py::_simulate_core``, l. 729–742): gather
each instance's output queue onto its edges (``f_want = qout[src]·share``),
sum the per-container origin demand and remote-arrival demand, throttle
each stream manager to its budget (``s_c = min(1, budget / demand)``),
limit every edge by the slowest stream manager on its path (``eff``), and
sum the throttled flow back onto instances and containers.

Two groupings of the same sums:

* :func:`stream_flow_reference` — per-edge segment sums straight into
  containers and instances (``index_add_``), the reference package's
  ``kernels/stream_flow/ref.py`` contract that its Pallas kernel meets;
* :func:`stream_flow_ell_reference` — the grouping the simulator's tick
  actually runs: per-instance ELL row sums, then aggregation of the
  instances onto their containers.  The CUDA kernel computes this one.

Both agree to float tolerance; the summation order differs.
"""
from __future__ import annotations

import numpy as np
import torch


def stream_flow_reference(
    qout: torch.Tensor,           # (I,) or (B, I) output-queue depth (ktuples)
    edge_src: torch.Tensor,       # (E,) / (B, E) source instance per edge
    edge_dst: torch.Tensor,       # (E,) / (B, E) destination instance per edge
    edge_share: torch.Tensor,     # (E,) / (B, E) fraction of src's qout on this edge
    edge_remote: torch.Tensor,    # (E,) / (B, E) 1.0 when the edge crosses containers
    edge_src_cont: torch.Tensor,  # (E,) / (B, E) source container per edge
    edge_dst_cont: torch.Tensor,  # (E,) / (B, E) destination container per edge
    sm_budget: torch.Tensor,      # (K,) / (B, K) traversals per stream manager this tick
    *,
    n_inst: int,
    n_cont: int,
):
    """Segment-sum flow step: returns ``(delivered, arrivals, trav_c)``.

    ``delivered`` / ``arrivals`` are per instance, ``trav_c`` per container
    (all originated copies plus remote arrivals, before padded-container
    masking).  Inputs may carry a leading batch axis; the segment sums then
    run once over the flattened batch with per-row index offsets.
    """
    batched = qout.dim() == 2
    if not batched:
        qout, edge_src, edge_dst, edge_share, edge_remote, edge_src_cont, \
            edge_dst_cont, sm_budget = (
                x.unsqueeze(0) for x in (
                    qout, edge_src, edge_dst, edge_share, edge_remote,
                    edge_src_cont, edge_dst_cont, sm_budget,
                )
            )
    B = qout.shape[0]
    rows = torch.arange(B, device=qout.device)[:, None]
    src = (edge_src.long() + rows * n_inst).reshape(-1)
    dst = (edge_dst.long() + rows * n_inst).reshape(-1)
    sc = (edge_src_cont.long() + rows * n_cont).reshape(-1)
    dc = (edge_dst_cont.long() + rows * n_cont).reshape(-1)
    share = edge_share.reshape(-1)
    remote = edge_remote.reshape(-1)

    def seg(vals, idx, n):
        return torch.zeros(B * n, dtype=vals.dtype, device=vals.device).index_add_(
            0, idx, vals
        )

    f_want = qout.reshape(-1)[src] * share                   # gather
    orig_c = seg(f_want, sc, n_cont)
    arr_c = seg(f_want * remote, dc, n_cont)
    s_c = torch.clamp(
        sm_budget.reshape(-1) / torch.clamp(orig_c + arr_c, min=1e-9), max=1.0
    )
    # a flow is limited by the slowest stream manager on its path (source
    # always; destination only when crossing containers)
    eff = torch.minimum(
        s_c[sc], torch.where(remote > 0, s_c[dc], torch.ones_like(remote))
    )
    f = f_want * eff                                          # throttle
    delivered = seg(f, src, n_inst)                           # scatter
    arrivals = seg(f, dst, n_inst)
    trav_c = seg(f, sc, n_cont) + seg(f * remote, dc, n_cont)
    out = tuple(x.reshape(B, -1) for x in (delivered, arrivals, trav_c))
    return out if batched else tuple(x[0] for x in out)


def _ell_sum(vals: torch.Tensor, ell: torch.Tensor) -> torch.Tensor:
    """Per-row sums of ``vals`` (B, E) gathered through ``ell`` (B, I, D);
    ids ``>= E`` read an appended exact 0.0 (the ELL row padding)."""
    B, E = vals.shape
    padded = torch.cat([vals, vals.new_zeros(B, 1)], dim=1)
    ids = torch.clamp(ell.long(), max=E).reshape(B, -1)
    return torch.gather(padded, 1, ids).reshape(ell.shape).sum(dim=2)


def container_sum_reference(vals: torch.Tensor, cont_of: torch.Tensor, n_cont: int) -> torch.Tensor:
    """(B, I) per-instance values summed onto (B, ``n_cont``) containers —
    the reference simulator's ``x @ C`` — with each container's members
    added one by one in instance order, starting from 0.0.

    The order is fixed by the instances alone, so the sums do not depend on
    how far I or K are padded (padded instances carry zeros), and they are
    bit for bit what the CUDA ``container_sum`` kernel computes from the
    member lists of :func:`container_members`.  On the CPU ``index_add_``
    into a flat tensor adds in index order.
    """
    B, I = vals.shape
    rows = torch.arange(B, device=vals.device)[:, None] * n_cont
    idx = (cont_of.long() + rows).reshape(-1)
    out = vals.new_zeros(B * n_cont).index_add_(0, idx, vals.reshape(-1))
    return out.reshape(B, n_cont)


def stream_flow_ell_reference(
    qout: torch.Tensor,           # (B, I) f32
    edge_src: torch.Tensor,       # (B, E) int source instance per edge
    edge_share: torch.Tensor,     # (B, E) f32
    edge_remote: torch.Tensor,    # (B, E) f32 (1.0 cross-container)
    edge_src_cont: torch.Tensor,  # (B, E) int
    edge_dst_cont: torch.Tensor,  # (B, E) int
    ell_src: torch.Tensor,        # (B, I, D_out) edge ids leaving each instance, E = empty
    ell_dst: torch.Tensor,        # (B, I, D_in) edge ids entering each instance, E = empty
    cont_of: torch.Tensor,        # (B, I) int container of each instance
    sm_budget: torch.Tensor,      # (B, K) f32
    cont_ptr: torch.Tensor | None = None,      # (B, K + 1) member-list offsets (unused here)
    cont_members: torch.Tensor | None = None,  # (B, I) member lists (unused here)
):
    """The simulator's flow step (per-instance ELL sums, then containers):
    returns ``(delivered, arrivals, trav_c)`` of shapes (B, I), (B, I),
    (B, K).  ``trav_c`` is before padded-container masking.  Containers sum
    their members in instance order (:func:`container_sum_reference`), as
    the CUDA kernel does through the member lists of
    :func:`container_members`; this version takes and ignores those."""
    K = sm_budget.shape[1]

    def to_containers(vals):
        return container_sum_reference(vals, cont_of, K)

    f_want = torch.gather(qout, 1, edge_src.long()) * edge_share
    orig_c = to_containers(_ell_sum(f_want, ell_src))
    arr_c = to_containers(_ell_sum(f_want * edge_remote, ell_dst))
    s_c = torch.clamp(sm_budget / torch.clamp(orig_c + arr_c, min=1e-9), max=1.0)
    eff = torch.minimum(
        torch.gather(s_c, 1, edge_src_cont.long()),
        torch.where(
            edge_remote > 0,
            torch.gather(s_c, 1, edge_dst_cont.long()),
            torch.ones_like(edge_remote),
        ),
    )
    f = f_want * eff
    delivered = _ell_sum(f, ell_src)
    arrivals = _ell_sum(f, ell_dst)
    trav_c = to_containers(delivered) + to_containers(_ell_sum(f * edge_remote, ell_dst))
    return delivered, arrivals, trav_c


def container_members(cont_of: torch.Tensor, n_cont: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's containers as member lists: ``(cont_ptr, cont_members)``.

    ``cont_members`` (B, I) is the instances sorted stably by container, so
    row ``b``'s container ``k`` holds ``cont_members[b, cont_ptr[b, k] :
    cont_ptr[b, k + 1]]`` in instance order; ``cont_ptr`` is (B, K + 1).
    Every instance is listed, padded ones included (they sit in whatever
    container ``cont_of`` gives them).  Both come in ``cont_of``'s dtype and
    on its device; ``cont_of`` must lie in ``[0, n_cont)``.
    """
    ranked, members = torch.sort(cont_of, dim=1, stable=True)
    bounds = torch.arange(n_cont + 1, dtype=cont_of.dtype, device=cont_of.device)
    cont_ptr = torch.searchsorted(ranked, bounds.expand(cont_of.shape[0], -1).contiguous())
    return cont_ptr.to(cont_of.dtype), members.to(cont_of.dtype)


def ell_rows(keys: np.ndarray, n_rows: int, width: int, sentinel: int) -> np.ndarray:
    """ELL layout of an edge list: row ``r`` lists, in edge order, the ids
    of the edges whose key (source or destination instance) is ``r``; the
    rest of the row holds ``sentinel``.  (n_rows, width) int32."""
    keys = np.asarray(keys)
    out = np.full((n_rows, width), sentinel, np.int32)
    if keys.size:
        order = np.argsort(keys, kind="stable")
        ranked = keys[order]
        starts = np.searchsorted(ranked, np.arange(n_rows))
        out[ranked, np.arange(keys.size) - starts[ranked]] = order
    return out
