"""Vectorized discrete-time cluster simulator — the "physical truth", on
PyTorch.

It plays the role of the Heron cluster in the paper: it executes a
:class:`~repro_torch.core.dag.Configuration` tick by tick and emits the
runtime metrics Heron exposes (§4): per-instance tuple rates, ``cputil``,
``capacityutil``, sawtooth ``memutil``, ``gctime`` and ``backpressure``,
plus the same metrics for every stream manager.  The physics is the
reference package's, including the non-linear effects Trevor's linear
models do not know about: two stream-manager traversals per
cross-container tuple, container CPU contention, runtime-overhead threads,
stream-manager fan-out cost, spout backpressure with hysteresis, a JVM-style
memory sawtooth with GC pauses, and multiplicative cost noise.

Layout
------
The host half (numpy) builds each configuration's static arrays
(:func:`build_structure`) and pads them to shape buckets
(:func:`pad_structure`); its padded arrays equal the reference's exactly.
The device half (:func:`_simulate_core`) runs a batch of padded
configurations as eager torch on one device: a leading batch axis stands in
for ``vmap`` and Python loops over sample windows and ticks stand in for
the window-nested ``lax.scan``, with per-window metric means accumulated in
place.  The flow step has two backends: ``"dense"`` (an (I, I) flow matrix
whose row and column sums run through
:func:`~repro_torch.kernels.stream_flow.ordered_sum`) and ``"sparse"``
(edge lists with ELL row gathers, one call to
:func:`~repro_torch.kernels.stream_flow.stream_flow_ell` per tick).  On the
card each is a hand-written CUDA kernel, as are the per-container sums
(:func:`~repro_torch.kernels.stream_flow.container_sum`); on the host their
plain versions run, in the same order.

Noise is the reference's: each row's seed keys JAX's threefry2x32
generator (:mod:`.prng`, integer torch math), split once per tick, and tick
``t`` draws ``normal(k_t, (I,))`` over the padded instances, so a row's
noise depends on its seed alone, not on the bucket or the batch.  The
normals equal ``jax.random.normal``'s to a few float32 ulps (``erfinv``
rounds differently; at most 6e-6 relative measured), so runs agree with the
reference to float tolerance with noise on or off.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from ..core.dag import Configuration, Grouping
from ..core.metrics import STREAM_MANAGER, InstanceSamples, MetricsStore
from ..device import resolve_device
from ..interop import stage_padded
from ..kernels.stream_flow.ops import (
    check_member_lists, container_sum, ordered_sum, stream_flow_ell,
)
from ..kernels.stream_flow.ref import container_members, ell_rows
from . import prng


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Physics of the simulated cluster."""

    dt: float = 0.01                   # tick length (seconds)
    sm_cost_per_ktuple: float = 1.0 / 724.0   # sec CPU per ktuple traversal
    sm_fanout_coef: float = 0.015      # per-remote-peer routing overhead
    cpu_overhead_mult: float = 1.12    # runtime helper threads (cputil > caputil)
    noise_std: float = 0.03            # multiplicative per-tick cost noise
    queue_high_ktuples: float = 50.0   # backpressure high watermark
    queue_low_ktuples: float = 10.0    # resume watermark
    gc_heap_mb: float = 512.0          # per-instance heap above live set
    gc_cost_frac: float = 0.05         # gc time fraction while collecting
    mem_alloc_mb_per_ktuple: float = 0.02
    sample_every: int = 25             # ticks per metric sample
    seed: int = 0


@dataclasses.dataclass
class SimStructure:
    """Static arrays describing one configuration (host-side, numpy)."""

    config: Configuration
    n_inst: int
    n_cont: int
    node_of: np.ndarray          # (n_inst,) node index
    cont_of: np.ndarray          # (n_inst,) container index
    is_source: np.ndarray        # (n_inst,) bool
    busy_cost: np.ndarray        # (n_inst,) sec per ktuple (capacity cost)
    cpu_cost: np.ndarray         # (n_inst,) CPU-sec per ktuple (on-CPU, incl. overhead)
    gamma: np.ndarray            # (n_inst,)
    mem_base: np.ndarray         # (n_inst,) MB
    mem_slope: np.ndarray        # (n_inst,) MB per ktps
    W: np.ndarray                # (n_inst, n_inst) routing weights (copies per output tuple)
    remote: np.ndarray           # (n_inst, n_inst) bool, cross-container
    cont_cpus: np.ndarray        # (n_cont,)
    cont_mem: np.ndarray         # (n_cont,)
    sm_cost_eff: np.ndarray      # (n_cont,) per-traversal SM cost incl. fan-out overhead
    rowsum_W: np.ndarray         # (n_inst,)
    node_names: list[str]
    #: The nonzeros of ``W`` in row-major order, for the sparse backend.
    edge_src: np.ndarray         # (n_edges,) int32 source instance
    edge_dst: np.ndarray         # (n_edges,) int32 destination instance
    edge_w: np.ndarray           # (n_edges,) routing weight W[src, dst]
    edge_remote: np.ndarray      # (n_edges,) bool, cross-container edge
    n_edges: int
    d_out: int                   # max out-degree (edges per source instance)
    d_in: int                    # max in-degree (edges per dest instance)


def build_structure(config: Configuration, params: SimParams) -> SimStructure:
    dag = config.dag
    instances = config.instances()
    n_inst = len(instances)
    n_cont = config.n_containers
    name_to_idx = {n: i for i, n in enumerate(dag.node_names)}
    node_of = np.array([name_to_idx[nm] for nm, _c, _s in instances], np.int32)
    cont_of = np.array([c for _n, c, _s in instances], np.int32)
    src_names = {s.name for s in dag.sources()}
    is_source = np.array([nm in src_names for nm, _c, _s in instances])

    # per-node cost vectors gathered onto instances by ``node_of``
    node_specs = [dag.node(nm) for nm in dag.node_names]
    busy_cost = np.array([s.cpu_cost_per_ktuple for s in node_specs])[node_of]
    cpu_cost = np.array(
        [s.cpu_cost_per_ktuple * (1.0 - s.io_fraction) * params.cpu_overhead_mult
         for s in node_specs]
    )[node_of]
    gamma = np.array([s.gamma for s in node_specs])[node_of]
    mem_base = np.array([s.mem_mb_base for s in node_specs])[node_of]
    mem_slope = np.array([s.mem_mb_per_ktps for s in node_specs])[node_of]

    inst_of_node: dict[str, list[int]] = {}
    for i, (nm, _c, _s) in enumerate(instances):
        inst_of_node.setdefault(nm, []).append(i)

    # routing weights: one block-add per DAG edge, edge-major, so repeated
    # edges between the same node pair sum in the reference's order
    W = np.zeros((n_inst, n_inst))
    for e in dag.edges:
        ups = inst_of_node.get(e.src, [])
        downs = inst_of_node.get(e.dst, [])
        if not ups or not downs:
            raise ValueError(f"edge {e.src}->{e.dst} lacks instances")
        w = 1.0 if e.grouping is Grouping.ALL else 1.0 / len(downs)
        W[np.ix_(ups, downs)] += w
    remote = cont_of[:, None] != cont_of[None, :]
    edge_src, edge_dst = (x.astype(np.int32) for x in np.nonzero(W))

    # fan-out overhead: distinct remote peer containers of each stream
    # manager (both directions of a cross-container edge count)
    conn = np.zeros((n_cont, n_cont), bool)
    cross = cont_of[edge_src] != cont_of[edge_dst]
    conn[cont_of[edge_src[cross]], cont_of[edge_dst[cross]]] = True
    n_peers = (conn | conn.T).sum(axis=1)
    sm_cost_eff = params.sm_cost_per_ktuple * (
        1.0 + params.sm_fanout_coef * n_peers
    )
    return SimStructure(
        config=config,
        n_inst=n_inst,
        n_cont=n_cont,
        node_of=node_of,
        cont_of=cont_of,
        is_source=is_source,
        busy_cost=busy_cost,
        cpu_cost=cpu_cost,
        gamma=gamma,
        mem_base=mem_base,
        mem_slope=mem_slope,
        W=W,
        remote=remote,
        cont_cpus=np.array([d.cpus for d in config.dims]),
        cont_mem=np.array([d.mem_mb for d in config.dims]),
        sm_cost_eff=sm_cost_eff,
        rowsum_W=W.sum(axis=1),
        node_names=list(dag.node_names),
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_w=W[edge_src, edge_dst],
        edge_remote=remote[edge_src, edge_dst],
        n_edges=int(edge_src.shape[0]),
        d_out=int(np.bincount(edge_src, minlength=n_inst).max())
        if edge_src.size else 0,
        d_in=int(np.bincount(edge_dst, minlength=n_inst).max())
        if edge_dst.size else 0,
    )


# ---------------------------------------------------------------------------
# Structure memoization
# ---------------------------------------------------------------------------

#: ``build_structure`` is pure in ``(config, params)`` (both frozen,
#: hashable by value), so structures and their padded layouts are kept in
#: bounded LRUs keyed by value: two equal Configuration objects share one.
_STRUCTURE_CACHE: "OrderedDict[tuple, SimStructure]" = OrderedDict()
_PAD_CACHE: "OrderedDict[tuple, dict]" = OrderedDict()
_STRUCTURE_CACHE_MAX = 4096
_STRUCTURE_STATS = {"hits": 0, "misses": 0}


def _lru_get(cache: OrderedDict, key, build):
    hit = cache.get(key)
    if hit is not None:
        _STRUCTURE_STATS["hits"] += 1
        cache.move_to_end(key)
        return hit
    _STRUCTURE_STATS["misses"] += 1
    out = build()
    cache[key] = out
    if len(cache) > _STRUCTURE_CACHE_MAX:
        cache.popitem(last=False)
    return out


def structure_for(config: Configuration, params: SimParams) -> SimStructure:
    """Memoized :func:`build_structure`, keyed by value (treat the result as
    read-only)."""
    return _lru_get(
        _STRUCTURE_CACHE, (config, params), lambda: build_structure(config, params)
    )


def _padded_for(
    st: SimStructure,
    params: SimParams,
    n_inst_bucket: int,
    n_cont_bucket: int,
    n_edge_bucket: int | None = None,
    d_out_bucket: int | None = None,
    d_in_bucket: int | None = None,
) -> dict:
    """Memoized :func:`pad_structure`, with the dense layout's
    :func:`padded_rowsum` added as ``"rowsum"`` (the sparse layout carries
    it already).  The arrays are shared across calls: read-only."""

    def build() -> dict:
        arrays = pad_structure(st, n_inst_bucket, n_cont_bucket, n_edge_bucket,
                               d_out_bucket, d_in_bucket)
        if n_edge_bucket is None:
            arrays = {**arrays, "rowsum": padded_rowsum(st, n_inst_bucket)}
        return arrays

    return _lru_get(
        _PAD_CACHE,
        (st.config, params, n_inst_bucket, n_cont_bucket, n_edge_bucket,
         d_out_bucket, d_in_bucket),
        build,
    )


def _ndarray_bytes(obj) -> int:
    """Bytes of the numpy arrays hanging off ``obj`` (a
    :class:`SimStructure` or a padded-array dict)."""
    values = obj.values() if isinstance(obj, dict) else vars(obj).values()
    return sum(v.nbytes for v in values if isinstance(v, np.ndarray))


def structure_cache_info() -> dict:
    """Host-side structure/padding memo statistics (entries, their numpy
    bytes, hits and misses)."""
    return {
        "structures": len(_STRUCTURE_CACHE),
        "padded": len(_PAD_CACHE),
        "structure_bytes": sum(
            _ndarray_bytes(v) for v in _STRUCTURE_CACHE.values()
        ),
        "padded_bytes": sum(_ndarray_bytes(v) for v in _PAD_CACHE.values()),
        **_STRUCTURE_STATS,
    }


def clear_structure_cache() -> None:
    _STRUCTURE_CACHE.clear()
    _PAD_CACHE.clear()
    _STRUCTURE_STATS["hits"] = 0
    _STRUCTURE_STATS["misses"] = 0


# ---------------------------------------------------------------------------
# Shape bucketing + padding
# ---------------------------------------------------------------------------

#: Instance/container bucket ladder; past the top rung, multiples of it.
BUCKET_LADDER = (8, 32, 128, 512)
#: Batch-axis ladder (candidate count) for ``min_batch_bucket``.
BATCH_LADDER = (8, 16, 32, 64, 128, 256, 512)
#: Edge-axis ladder of the sparse backend.
EDGE_LADDER = (32, 128, 512, 2048, 8192)
#: ELL row-width ladder (max in-/out-degree).
DEGREE_LADDER = (4, 16, 64, 256)


def _ladder_size(ladder: tuple[int, ...], n: int, floor: int) -> int:
    n = max(int(n), int(floor), 1)
    for b in ladder:
        if n <= b:
            return b
    return -(-n // ladder[-1]) * ladder[-1]


def bucket_size(n: int, floor: int = 0) -> int:
    """Round ``n`` up to :data:`BUCKET_LADDER` (``floor`` is sticky)."""
    return _ladder_size(BUCKET_LADDER, n, floor)


def batch_bucket_size(n: int, floor: int = 0) -> int:
    """Round a batch size up to :data:`BATCH_LADDER` (``floor`` is sticky)."""
    return _ladder_size(BATCH_LADDER, n, floor)


def edge_bucket_size(n: int, floor: int = 0) -> int:
    """Round an edge count up to :data:`EDGE_LADDER` (``floor`` is sticky)."""
    return _ladder_size(EDGE_LADDER, n, floor)


def degree_bucket_size(n: int, floor: int = 0) -> int:
    """Round an ELL row width up to :data:`DEGREE_LADDER` (``floor`` is
    sticky)."""
    return _ladder_size(DEGREE_LADDER, n, floor)


#: ``tick_kernel="auto"`` picks the sparse backend when the densest
#: structure in the batch has edge density ``E / I²`` at or below this
#: (unpadded counts, so bucket floors never flip the choice).
SPARSE_DENSITY_THRESHOLD = 0.125

TICK_KERNELS = ("dense", "sparse", "auto")

#: ``"full"`` returns the windowed trajectories, ``"summary"`` only the
#: O(B·I) reductions of :func:`_summarize_windowed`.
SAMPLES_MODES = ("full", "summary")


def resolve_tick_kernel(n_inst: int, n_edges: int, tick_kernel: str = "auto") -> str:
    """Resolve a ``tick_kernel`` selector to a concrete backend from the
    *unpadded* maxima across the batch."""
    if tick_kernel not in TICK_KERNELS:
        raise ValueError(
            f"tick_kernel={tick_kernel!r} not in {TICK_KERNELS}"
        )
    if tick_kernel != "auto":
        return tick_kernel
    dense_cells = max(int(n_inst), 1) ** 2
    return "sparse" if n_edges <= SPARSE_DENSITY_THRESHOLD * dense_cells else "dense"


def padded_rowsum(st: SimStructure, n_inst_bucket: int) -> np.ndarray:
    """``W``'s float32 row sums (copies per output tuple), taken over the
    real instances on the host and padded with zeros to the bucket, so they
    do not depend on it.  Both ticks derive each edge's share from these."""
    out = np.zeros(int(n_inst_bucket), np.float32)
    out[: st.n_inst] = st.W.astype(np.float32).sum(axis=1)
    return out


def pad_structure(
    st: SimStructure,
    n_inst_bucket: int,
    n_cont_bucket: int,
    n_edge_bucket: int | None = None,
    d_out_bucket: int | None = None,
    d_in_bucket: int | None = None,
) -> dict:
    """Pad a :class:`SimStructure` to static bucket shapes (numpy).

    Padded instances have zero routing weight and zero cost and are never
    sources; padded containers receive no traffic; real entries occupy the
    leading positions.  ``n_edge_bucket=None`` lays out the dense backend's
    (I, I) routing/remote matrices; an integer lays out the sparse backend's
    padded edge list plus the ELL row-gather matrices ``ell_src`` (I, d_out)
    and ``ell_dst`` (I, d_in).  Padded edges carry zero share and point at
    the last instance/container; ELL rows list real edges only, padded with
    the sentinel id ``E``.  The arrays equal the reference package's
    ``pad_structure`` exactly.
    """
    I, K = int(n_inst_bucket), int(n_cont_bucket)
    if I < st.n_inst or K < st.n_cont:
        raise ValueError(
            f"bucket ({I},{K}) smaller than structure ({st.n_inst},{st.n_cont})"
        )

    def pad1(x, n, fill, dtype):
        out = np.full(n, fill, dtype)
        out[: x.shape[0]] = x
        return out

    sm_pad = float(st.sm_cost_eff.max()) if st.sm_cost_eff.size else 1e-3
    inst_mask = np.zeros(I, np.float32)
    inst_mask[: st.n_inst] = 1.0
    cont_mask = np.zeros(K, np.float32)
    cont_mask[: st.n_cont] = 1.0
    arrays = dict(
        busy_cost=pad1(st.busy_cost, I, 1.0, np.float32),
        cpu_cost=pad1(st.cpu_cost, I, 0.0, np.float32),
        gamma=pad1(st.gamma, I, 0.0, np.float32),
        is_source=pad1(st.is_source, I, False, bool),
        cont_of=pad1(st.cont_of, I, K - 1, np.int32),
        cont_cpus=pad1(st.cont_cpus, K, 1.0, np.float32),
        sm_cost_eff=pad1(st.sm_cost_eff, K, sm_pad, np.float32),
        mem_base=pad1(st.mem_base, I, 0.0, np.float32),
        mem_slope=pad1(st.mem_slope, I, 0.0, np.float32),
        inst_mask=inst_mask,
        cont_mask=cont_mask,
    )
    if n_edge_bucket is None:
        W = np.zeros((I, I), np.float32)
        W[: st.n_inst, : st.n_inst] = st.W
        remote = np.zeros((I, I), bool)
        remote[: st.n_inst, : st.n_inst] = st.remote
        arrays.update(W=W, remote=remote)
        return arrays

    E = int(n_edge_bucket)
    if E < st.n_edges:
        raise ValueError(
            f"edge bucket {E} smaller than structure ({st.n_edges} edges)"
        )
    # per-edge share of the source's output queue, in float32 exactly as the
    # dense backend derives it from W and the same row sums
    rowsum = padded_rowsum(st, I)
    share = st.edge_w.astype(np.float32) / np.maximum(
        rowsum[st.edge_src], 1e-9
    )
    edge_mask = np.zeros(E, np.float32)
    edge_mask[: st.n_edges] = 1.0
    D_out = int(d_out_bucket) if d_out_bucket is not None else degree_bucket_size(st.d_out)
    D_in = int(d_in_bucket) if d_in_bucket is not None else degree_bucket_size(st.d_in)
    if D_out < st.d_out or D_in < st.d_in:
        raise ValueError(
            f"degree bucket ({D_out},{D_in}) smaller than structure "
            f"degrees ({st.d_out},{st.d_in})"
        )
    arrays.update(
        rowsum=rowsum,
        edge_src=pad1(st.edge_src, E, I - 1, np.int32),
        edge_dst=pad1(st.edge_dst, E, I - 1, np.int32),
        edge_share=pad1(share, E, 0.0, np.float32),
        edge_remote=pad1(st.edge_remote.astype(np.float32), E, 0.0, np.float32),
        edge_src_cont=pad1(st.cont_of[st.edge_src], E, K - 1, np.int32),
        edge_dst_cont=pad1(st.cont_of[st.edge_dst], E, K - 1, np.int32),
        edge_mask=edge_mask,
        ell_src=ell_rows(st.edge_src, I, D_out, E),
        ell_dst=ell_rows(st.edge_dst, I, D_in, E),
    )
    return arrays


# ---------------------------------------------------------------------------
# The tick (eager torch, batched over configurations)
# ---------------------------------------------------------------------------


def _summarize_windowed(samples: dict, is_source: torch.Tensor) -> dict:
    """The summary reductions of a batch of windowed trajectories.

    ``samples`` holds (B, S, I) per-instance series, (B, S, K)
    per-container series and the (B, S) gate; ``is_source`` (B, I) marks
    the sources.  Returns per row: ``src_half_mean`` (second-half mean of
    the total source throughput per sample, ktuples/tick),
    ``caputil_half_mean`` / ``bp_half_mean`` (I,), ``sm_half_mean`` (K,),
    ``mem_peak`` (I,) and ``gate_final``.
    """
    proc = samples["proc"]
    half = proc.shape[1] // 2
    # over the padded instances, in an order their padding cannot move
    per_sample_src = ordered_sum(proc * is_source[:, None, :], 2)
    return dict(
        src_half_mean=per_sample_src[:, half:].mean(dim=1),
        caputil_half_mean=samples["caputil"][:, half:].mean(dim=1),
        sm_half_mean=samples["sm_cpu"][:, half:].mean(dim=1),
        bp_half_mean=samples["bp"][:, half:].mean(dim=1),
        mem_peak=samples["mem"].amax(dim=1),
        gate_final=samples["gate"][:, -1],
    )


_SUMMARY_INPUT_KEYS = ("proc", "caputil", "sm_cpu", "bp", "mem", "gate")
_METRIC_KEYS = (
    "proc", "out", "caputil", "cputil", "mem", "gc", "bp", "sm_trav",
    "sm_cpu", "gate",
)


#: Normals drawn per pass of the noise (windows at a time, about 32 MiB
#: per int64 temporary of the threefry hash).
NOISE_DRAW_ELEMENTS = 1 << 22


def _simulate_core(
    arrays: dict,
    offered_per_tick: torch.Tensor,   # (B, n_ticks) total source ktuples per tick
    seeds: Sequence[int],
    params: SimParams,
    *,
    n_ticks: int,
    backend: str = "dense",
    samples_mode: str = "full",
) -> dict:
    """Trajectories of a batch of padded configurations (tensors (B, ...)).

    The tick is the reference's ``_simulate_core`` operation for operation.
    ``backend`` picks the stream-manager transfer: ``"dense"`` is the (I, I)
    flow matrix, ``"sparse"`` the edge-list step run by
    :func:`~repro_torch.kernels.stream_flow.stream_flow_ell`.  Row ``b``
    draws its noise from ``seeds[b]`` as the reference does (:mod:`.prng`);
    padded instances draw too and are masked out, every per-container sum
    runs in instance order, and every other sum over the padded instance
    axis (the dense tick's flow sums, the summary's source sum) in the fixed
    order of :func:`~repro_torch.kernels.stream_flow.ordered_sum`, so a
    row's result does not depend on the bucket or on the rest of the batch.
    ``arrays`` holds the padded structure of :func:`pad_structure` and, for
    the dense tick, the row sums of :func:`padded_rowsum` as ``"rowsum"``.
    Returns the windowed metric trajectories ((B, S, ...) per metric) or, in
    ``"summary"`` mode, :func:`_summarize_windowed` of them.  Nothing here
    waits on the device.
    """
    dt = params.dt
    noise_std = params.noise_std
    q_high = params.queue_high_ktuples
    q_low = params.queue_low_ktuples
    busy_cost = arrays["busy_cost"]
    cpu_cost = arrays["cpu_cost"]
    gamma = arrays["gamma"]
    is_source = arrays["is_source"]
    cont_cpus = arrays["cont_cpus"]
    sm_cost_eff = arrays["sm_cost_eff"]
    mem_base = arrays["mem_base"]
    mem_slope = arrays["mem_slope"]
    inst_mask = arrays["inst_mask"]
    cont_mask = arrays["cont_mask"]
    cont_of = arrays["cont_of"]
    device = busy_cost.device
    B, I = busy_cost.shape
    K = cont_cpus.shape[1]
    cont_long = cont_of.long()
    # every per-container sum walks these member lists in instance order,
    # so no sum depends on the padding; built once per run
    members = container_members(cont_of, K)
    whole_row = torch.zeros_like(cont_of)
    whole_members = container_members(whole_row, 1)
    if device.type == "cuda":
        for lists in (members, whole_members):
            check_member_lists(*lists, B, I, device)

    def to_containers(vals):
        return container_sum(vals, cont_of, *members, checked=True)

    n_src = is_source.sum(dim=1).clamp(min=1).to(torch.float32)
    sm_budget = dt / torch.clamp(sm_cost_eff, min=1e-9)   # traversals per tick
    rowsum = arrays["rowsum"]
    if backend == "dense":
        remote = arrays["remote"]
        share = arrays["W"] / torch.clamp(rowsum, min=1e-9)[:, :, None]
    elif backend == "sparse":
        edge_args = tuple(
            arrays[k] for k in (
                "edge_src", "edge_share", "edge_remote", "edge_src_cont",
                "edge_dst_cont", "ell_src", "ell_dst",
            )
        )
    else:
        raise ValueError(f"backend={backend!r} not in ('dense', 'sparse')")

    se = params.sample_every
    n_samples = n_ticks // se
    if noise_std > 0:
        # every tick's key of the run at once; the noise is drawn for
        # `chunk` windows per pass, (B, chunk·se, I) normals from counters
        # 0 .. I-1, which are the same values as one pass per window (each
        # depends only on its tick key and counter) for a fraction of the
        # launches
        tick_keys = prng.split(prng.prng_key(seeds, device), 0, n_samples * se)
        chunk = max(1, NOISE_DRAW_ELEMENTS // (B * se * I))
    else:
        tick_keys = None
    qin = torch.zeros(B, I, device=device)
    qout = torch.zeros(B, I, device=device)
    mem = mem_base + 0.0
    # initial admission starts LOW and grows multiplicatively (slow start);
    # the sources' capacity is summed in instance order too (all instances
    # as one container), as a padded-length torch.sum need not be
    src_cap0 = container_sum(
        torch.where(is_source, dt / torch.clamp(busy_cost, min=1e-9), 0.0),
        whole_row, *whole_members, checked=True,
    )[:, 0]
    admit = src_cap0 * 0.05
    sm_cpu_prev = torch.zeros(B, K, device=device)

    shapes = {k: (B, I) for k in _METRIC_KEYS}
    shapes.update(sm_trav=(B, K), sm_cpu=(B, K), gate=(B,))
    out = {
        k: torch.empty(B, n_samples, *shape[1:], device=device)
        for k, shape in shapes.items()
    }
    acc = [torch.zeros(shapes[k], device=device) for k in _METRIC_KEYS]

    for w in range(n_samples):
        if tick_keys is not None and w % chunk == 0:
            z = prng.normal(tick_keys[:, w * se:(w + chunk) * se], I)
            noise = torch.clamp(1.0 + noise_std * z, 0.7, 1.3)
        for a in acc:
            a.zero_()
        for t in range(se):
            offered = offered_per_tick[:, w * se + t]
            if tick_keys is not None:
                busy = busy_cost * noise[:, (w % chunk) * se + t]
            else:
                busy = busy_cost

            # 1) spouts admit min(offered, admit) per tick
            admitted = torch.minimum(offered, admit)
            src_want = admitted / n_src

            # 2) desired processing, limited by single-thread capacity
            cap_tuples = dt / torch.clamp(busy, min=1e-9)
            want = torch.where(
                is_source,
                torch.minimum(src_want[:, None], cap_tuples),
                torch.minimum(qin, cap_tuples),
            )
            want = want * inst_mask

            # 3) container CPU contention (incl. last tick's SM CPU)
            demand = to_containers(want * cpu_cost) + sm_cpu_prev
            scale_c = torch.clamp(
                cont_cpus * dt / torch.clamp(demand, min=1e-9), max=1.0
            )
            proc = want * torch.gather(scale_c, 1, cont_long)
            qin = qin - torch.where(is_source, 0.0, proc)
            out_copies = proc * gamma * rowsum
            qout = qout + out_copies

            # 4) stream-manager transfer with per-container budgets
            if backend == "dense":
                # row sums by source, column sums by destination (remote
                # ones masked in), each in ordered_sum's fixed order
                F_want = qout[:, :, None] * share
                orig_c = to_containers(ordered_sum(F_want, 2))
                arr_c = to_containers(ordered_sum(F_want, 1, remote))
                s_c = torch.clamp(
                    sm_budget / torch.clamp(orig_c + arr_c, min=1e-9), max=1.0
                )
                s_inst = torch.gather(s_c, 1, cont_long)
                # a flow is limited by the slowest SM on its path
                eff = torch.minimum(
                    s_inst[:, :, None],
                    torch.where(remote, s_inst[:, None, :], 1.0),
                )
                F = F_want * eff
                delivered = ordered_sum(F, 2)
                arrivals = ordered_sum(F, 1)
                trav_c = to_containers(delivered) + to_containers(
                    ordered_sum(F, 1, remote)
                )
            else:
                delivered, arrivals, trav_c = stream_flow_ell(
                    qout, *edge_args, cont_of, sm_budget, *members
                )
            qout = qout - delivered
            qin = qin + torch.where(is_source, 0.0, arrivals)

            # SM CPU this tick (feeds next tick's contention)
            trav_c = trav_c * cont_mask
            sm_cpu = trav_c * sm_cost_eff

            # 5) memory sawtooth + GC
            mem_live = mem_base + mem_slope * (proc / dt)
            mem = torch.maximum(
                mem + proc * params.mem_alloc_mb_per_ktuple, mem_live
            )
            gc_trigger = mem > (mem_live + params.gc_heap_mb)
            mem = torch.where(gc_trigger, mem_live, mem)

            # 6) spout throttle: per-row backpressure with hysteresis
            qin_max = qin.amax(dim=1)
            qout_max = qout.amax(dim=1)
            congested = (qin_max > q_high) | (qout_max > q_high)
            relaxed = (qin_max < q_low) & (qout_max < q_low)
            admit = torch.where(
                congested, admit * 0.98,
                torch.where(relaxed, admit * 1.02, admit),
            )
            admit = torch.clamp(admit, 1e-3, 1e9)

            # one multi-tensor launch on the card instead of one per metric
            torch._foreach_add_(acc, [
                proc,
                proc * gamma,
                proc * busy / dt,
                proc * cpu_cost / dt,
                mem,
                gc_trigger.to(torch.float32) * params.gc_cost_frac,
                torch.where(
                    is_source,
                    (admitted < 0.98 * offered).to(torch.float32)[:, None],
                    (qin > q_high).to(torch.float32),
                ),
                trav_c,
                sm_cpu / dt,
                admit,
            ])
            sm_cpu_prev = sm_cpu
        for k, a in zip(_METRIC_KEYS, acc):
            out[k][:, w] = a / se
    if samples_mode == "summary":
        return _summarize_windowed(out, is_source)
    return out


# ---------------------------------------------------------------------------
# Launch shapes, sharding, device-resident batches, transfers
# ---------------------------------------------------------------------------

#: The distinct launch shapes run so far: (per-shard batch, buckets, ticks,
#: shards, backend, samples mode).  The port compiles nothing per shape (the
#: kernels are built once, for any shape); the reference compiles one XLA
#: executable per shape, so :func:`kernel_cache_info` reports these shapes
#: under its compile-cache names, a "miss" being the first run at a shape.
_LAUNCH_SHAPES: dict[tuple, None] = {}
_LAUNCH_SHAPE_STATS = {"hits": 0, "misses": 0}
_LAUNCH_SHAPE_FIELDS = ("batch", "n_inst", "n_cont", "n_ticks", "sample_every", "devices",
                        "backend", "n_edges", "d_out", "d_in", "samples")


def _note_shape(key: tuple) -> None:
    if key in _LAUNCH_SHAPES:
        _LAUNCH_SHAPE_STATS["hits"] += 1
    else:
        _LAUNCH_SHAPE_STATS["misses"] += 1
        _LAUNCH_SHAPES[key] = None


def kernel_cache_info() -> dict:
    """Distinct launch shapes, under the reference's compile-cache names:
    ``misses`` (and ``size``) count the shapes run, ``hits`` the runs at a
    shape seen before, ``entries`` describes each shape."""
    return {
        "size": len(_LAUNCH_SHAPES),
        **_LAUNCH_SHAPE_STATS,
        "entries": [dict(zip(_LAUNCH_SHAPE_FIELDS, k)) for k in _LAUNCH_SHAPES],
    }


def clear_kernel_cache() -> None:
    """Forget the launch shapes counted by :func:`kernel_cache_info`."""
    _LAUNCH_SHAPES.clear()
    _LAUNCH_SHAPE_STATS["hits"] = 0
    _LAUNCH_SHAPE_STATS["misses"] = 0


def shard_count(batch: int, devices: int | None = None, device=None) -> int:
    """How many devices :func:`simulate_batch` shards a batch over: one
    shard per CUDA card (``cuda:0 … cuda:n-1``); a CPU run has one device.
    ``device`` is the run's device (``None``: CUDA).

    ``devices=None`` keeps the batch on the run's one device.  Unlike the
    reference, which shards automatically while every shard keeps two
    configurations, the port shards only when the caller passes a count:
    its shards run one after another from one host thread, bit for bit
    one card's rows and slower than one card on four H100s
    (``tools/sim_multi_card.py``).  An explicit count pins the shard
    count (never more shards than rows), and asking for more devices than
    the host has raises."""
    if devices is None:
        return 1
    dev = torch.device("cuda" if device is None else device)
    available = torch.cuda.device_count() if dev.type == "cuda" else 1
    n = int(devices)
    if n > available:
        raise ValueError(
            f"devices={n} requested but only {available} local "
            f"device(s) are available"
        )
    return max(1, min(n, int(batch)))


#: Staged, stacked structure tensors keyed by (configs, params, buckets,
#: backend, shard layout, device): a caller that re-submits the same
#: candidate set skips ``np.stack`` and the host→device copies.  LRU-bounded
#: by entries and by bytes.
_RESIDENT_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_RESIDENT_STATS = {"hits": 0, "misses": 0, "bytes": 0}
_RESIDENT_CACHE_MAX_ENTRIES = 32
_RESIDENT_CACHE_MAX_BYTES = 1 << 28      # 256 MB of staged batch tensors


def _resident_put(key: tuple, shards: list[dict]) -> None:
    nbytes = sum(t.numel() * t.element_size() for s in shards for t in s.values())
    if nbytes > _RESIDENT_CACHE_MAX_BYTES:
        return                            # larger than the whole budget
    _RESIDENT_CACHE[key] = (shards, nbytes)
    _RESIDENT_STATS["bytes"] += nbytes
    while (
        len(_RESIDENT_CACHE) > _RESIDENT_CACHE_MAX_ENTRIES
        or _RESIDENT_STATS["bytes"] > _RESIDENT_CACHE_MAX_BYTES
    ):
        _, (_, evicted) = _RESIDENT_CACHE.popitem(last=False)
        _RESIDENT_STATS["bytes"] -= evicted


def resident_cache_info() -> dict:
    """Batch-staging (device-residency) cache statistics."""
    return {"size": len(_RESIDENT_CACHE), **_RESIDENT_STATS}


def clear_resident_cache() -> None:
    _RESIDENT_CACHE.clear()
    _RESIDENT_STATS["hits"] = 0
    _RESIDENT_STATS["misses"] = 0
    _RESIDENT_STATS["bytes"] = 0


#: Device→host transfers of the evaluation path: ``bytes_full`` /
#: ``bytes_summary`` count the bytes of each batch's one copy of its
#: outputs to the host, by payload mode; ``refetches`` counts
#: summary-backed results that re-ran in full mode for their trajectory.
_TRANSFER_STATS = {
    "batches": 0, "bytes_full": 0, "bytes_summary": 0, "refetches": 0,
}


def transfer_info() -> dict:
    """Device→host transfer statistics of the evaluation path."""
    return dict(_TRANSFER_STATS)


def clear_transfer_stats() -> None:
    for k in _TRANSFER_STATS:
        _TRANSFER_STATS[k] = 0


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------


class TrajectoryUnavailable(RuntimeError):
    """Raised on trajectory access (``SimResult.samples``) of a
    summary-backed result that has no refetch hook: the trajectory never
    left the device."""


def _bottleneck_from_reductions(
    node_of: np.ndarray,
    node_names: list,
    half: np.ndarray,
    sm_busy: float,
    saturation_threshold: float,
    sm_threshold: float,
) -> str | None:
    """Bottleneck attribution from second-half reductions: the node with the
    highest per-instance mean caputil (ties go to the node that appears
    first in instance order), or the stream manager when it is busier."""
    node_of = np.asarray(node_of)
    vals = np.asarray(half, np.float64)
    node_max = np.zeros(len(node_names), np.float64)
    np.maximum.at(node_max, node_of, vals)
    uniq, first = np.unique(node_of, return_index=True)
    order = uniq[np.argsort(first, kind="stable")]
    j = int(np.argmax(node_max[order]))
    name = node_names[int(order[j])]
    val = float(node_max[order[j]])
    if sm_busy > val and sm_busy > sm_threshold:
        return STREAM_MANAGER
    return name if val > saturation_threshold else None


def _host_summary(samples: dict, is_source: np.ndarray) -> dict:
    """Summary of one host-side (sliced) trajectory, through the same
    reductions summary mode runs on the device."""
    sub = {k: torch.from_numpy(np.asarray(samples[k]))[None] for k in _SUMMARY_INPUT_KEYS}
    out = _summarize_windowed(sub, torch.from_numpy(np.asarray(is_source))[None])
    return {k: v[0].numpy() for k, v in out.items()}


class SimResult:
    """One configuration's evaluation result.

    ``mode="full"`` results hold the windowed metric trajectory in
    :attr:`samples`; ``mode="summary"`` results hold only the summary
    reductions (:attr:`summary`), and trajectory access re-runs the row in
    full mode through the ``refetch`` hook (bit for bit what full mode
    returns, since a row's run does not depend on its buckets or batch) or,
    without one, raises :class:`TrajectoryUnavailable`.
    :attr:`achieved_ktps` and :meth:`bottleneck_node` answer from the
    summary in both modes.
    """

    def __init__(
        self,
        structure: SimStructure,
        params: SimParams,
        offered_ktps: np.ndarray,
        samples: dict | None = None,
        summary: dict | None = None,
        mode: str = "full",
        refetch=None,
    ) -> None:
        if samples is None and summary is None:
            raise ValueError("SimResult needs samples and/or summary")
        self.structure = structure
        self.params = params
        self.offered_ktps = offered_ktps
        self.mode = mode
        self._samples = samples
        self._summary = summary
        self._refetch = refetch
        self._achieved: float | None = None

    @property
    def samples(self) -> dict:
        """The windowed metric trajectory (numpy, sliced to real entries);
        a summary-backed result refetches it once (one full-mode run of
        the row, counted in :func:`transfer_info` as a ``refetch``)."""
        if self._samples is None:
            if self._refetch is None:
                raise TrajectoryUnavailable(
                    "summary-backed SimResult has no trajectory; re-evaluate "
                    "with samples='full'"
                )
            _TRANSFER_STATS["refetches"] += 1
            self._samples = self._refetch()
        return self._samples

    @property
    def summary(self) -> dict:
        """The :func:`_summarize_windowed` reductions (numpy, sliced to the
        real instance/container counts)."""
        if self._summary is None:
            self._summary = _host_summary(self._samples, self.structure.is_source)
        return self._summary

    @property
    def achieved_ktps(self) -> float:
        """Steady-state delivered source rate (mean of the second half)."""
        if self._achieved is None:
            self._achieved = float(
                self.summary["src_half_mean"] / self.params.dt
            )
        return self._achieved

    def bottleneck_node(
        self,
        saturation_threshold: float = 0.8,
        sm_threshold: float = 0.9,
    ) -> str | None:
        """Most saturated node (mean caputil over the last half), or the
        stream manager when it dominates; ``None`` when nothing exceeds
        ``saturation_threshold``."""
        s = self.summary
        sm_half = np.asarray(s["sm_half_mean"])
        sm_busy = float(sm_half.max()) if sm_half.size else 0.0
        return _bottleneck_from_reductions(
            self.structure.node_of,
            self.structure.node_names,
            s["caputil_half_mean"],
            sm_busy,
            saturation_threshold,
            sm_threshold,
        )

    def to_metrics_store(self) -> MetricsStore:
        """Package the trajectory as Heron-style metric timeseries."""
        store = MetricsStore()
        st = self.structure
        dt = self.params.dt
        rows = {
            k: np.ascontiguousarray(np.asarray(self.samples[k]).T)
            for k in ("proc", "out", "cputil", "caputil", "mem", "gc", "bp")
        }
        proc = rows["proc"] / dt                           # ktps in
        out = rows["out"] / dt                             # ktps out
        names = [st.node_names[n] for n in st.node_of.tolist()]
        conts = st.cont_of.tolist()
        for i in range(st.n_inst):
            store.add(
                InstanceSamples(
                    node=names[i],
                    container=conts[i],
                    slot=i,
                    rate_in_ktps=proc[i],
                    rate_out_ktps=out[i],
                    cputil=rows["cputil"][i],
                    caputil=rows["caputil"][i],
                    memutil_mb=rows["mem"][i],
                    gctime=rows["gc"][i],
                    backpressure=rows["bp"][i],
                )
            )
        trav = np.ascontiguousarray(np.asarray(self.samples["sm_trav"]).T) / dt
        smc = np.ascontiguousarray(np.asarray(self.samples["sm_cpu"]).T)
        n_samples = trav.shape[1]
        sm_mem = np.full(n_samples, 256.0)
        sm_zero = np.zeros(n_samples)
        for c in range(st.n_cont):
            store.add(
                InstanceSamples(
                    node=STREAM_MANAGER,
                    container=c,
                    slot=-1,
                    rate_in_ktps=trav[c],
                    rate_out_ktps=trav[c],
                    cputil=smc[c],
                    caputil=smc[c],
                    memutil_mb=sm_mem,
                    gctime=sm_zero,
                    backpressure=sm_zero,
                )
            )
        return store


def is_scalar_load(x) -> bool:
    """True for a plain/0-d scalar offered load."""
    return np.isscalar(x) or getattr(x, "ndim", None) == 0


def _per_tick_trace(offered_ktps, n_ticks: int, dt: float) -> np.ndarray:
    """Expand a scalar rate or a piecewise-constant trace to per-tick loads:
    each of a trace's ``L`` entries is held ``ceil(n_ticks / L)`` ticks and
    the expansion is cut at ``n_ticks``.  An empty trace raises."""
    offered = np.asarray(offered_ktps, np.float64)
    if offered.ndim == 0:
        return np.full(n_ticks, float(offered) * dt)
    if offered.shape[0] == 0:
        raise ValueError("offered_ktps trace is empty: no rate to hold")
    reps = int(np.ceil(n_ticks / offered.shape[0]))
    return np.repeat(offered, reps)[:n_ticks] * dt


# ---------------------------------------------------------------------------
# Host-side API
# ---------------------------------------------------------------------------


#: Tier-1 accounting: rows submitted, value-distinct rows, and rows that
#: reached the device (distinct rows less result-cache hits).
_DEDUP_STATS = {"batches": 0, "rows_in": 0, "rows_unique": 0, "rows_executed": 0}


def dedup_info() -> dict:
    """In-batch request-dedup statistics for :func:`simulate_batch`:
    ``rows_in`` submitted rows, ``rows_unique`` value-distinct rows, and
    ``rows_executed`` the rows that actually ran (unique rows minus
    result-cache hits)."""
    return dict(_DEDUP_STATS)


def clear_dedup_stats() -> None:
    for k in _DEDUP_STATS:
        _DEDUP_STATS[k] = 0


def _canonical_load(offered) -> object:
    """Hashable value key for one offered-load entry: scalars collapse to
    ``float`` (``400`` and ``400.0`` are one request), per-sample traces to
    their float64 shape and bytes."""
    if is_scalar_load(offered):
        return float(offered)
    a = np.asarray(offered, np.float64)
    return ("trace", a.shape, a.tobytes())


def _result_nbytes(res: SimResult) -> int:
    """Resident bytes of one cached :class:`SimResult`: its samples, or its
    much smaller summary (the structure is shared through
    :func:`structure_for`)."""
    payload = res._samples if res._samples is not None else res._summary
    return int(
        sum(np.asarray(v).nbytes for v in payload.values())
        + np.asarray(res.offered_ktps).nbytes
    )


def simulate_batch(
    configs: Sequence[Configuration],
    offered_ktps,
    duration_s: float = 20.0,
    params: SimParams = SimParams(),
    seeds: Sequence[int] | None = None,
    min_inst_bucket: int = 0,
    min_cont_bucket: int = 0,
    devices: int | None = None,
    min_batch_bucket: int = 0,
    tick_kernel: str = "auto",
    min_edge_bucket: int = 0,
    min_degree_bucket: int = 0,
    resident: bool = False,
    samples: str = "full",
    dedup: bool = True,
    cache=None,
    cache_token=None,
    device=None,
) -> list[SimResult]:
    """Evaluate N configurations in one batched run on ``device`` (the CUDA
    card unless the caller names another).

    ``offered_ktps`` is one scalar load shared by every configuration or a
    sequence of per-configuration loads (each a scalar or a per-sample
    trace).  Every configuration is padded to common buckets; the
    ``min_*_bucket`` floors pin buckets from below, and ``min_batch_bucket``
    pads the batch axis to a :data:`BATCH_LADDER` rung by replicating the
    last configuration (replicas are dropped).  ``tick_kernel`` is
    ``"dense"``, ``"sparse"`` or ``"auto"`` (:func:`resolve_tick_kernel`).
    ``samples="full"`` returns each row's windowed trajectory,
    ``"summary"`` only its O(I) reductions; a summary-backed result
    refetches its trajectory on access.  The outputs reach the host once
    per batch, after the last tick (:func:`transfer_info`).

    ``devices`` shards the batch over CUDA cards (:func:`shard_count`;
    ``None`` keeps it on ``device``): the batch is padded to a multiple of the shard count by replicating the
    last row, and shard ``k`` runs on ``cuda:k``.  ``resident=True`` keeps
    the staged, stacked structure tensors in an LRU
    (:func:`resident_cache_info`), so a resubmitted candidate set skips
    stacking and staging; per-tick loads and seeds are staged fresh.

    ``dedup=True`` (Tier 1) collapses rows with equal (configuration,
    offered load, seed) before padding, runs the unique rows only and
    scatters the results back (duplicates share one :class:`SimResult`);
    :func:`dedup_info` counts them.  ``cache`` (Tier 2, a
    :class:`~repro_torch.streams.cache.ResultCache` or anything with
    ``get(key)`` / ``put(key, value, nbytes)``) memoizes unique rows across
    calls under (configuration, load, seed, params, tick count, resolved
    backend, samples mode, ``cache_token``, device type): the backend and
    the device because dense and sparse, and the card's flow kernel and
    the host's plain version, agree only to float tolerance; the mode so
    that a summary entry never answers a full lookup.  Buckets, residency
    and sharding are not in the key: a row's result does not depend on
    them.  ``cache_token`` is the caller's invalidation handle (the engine
    passes its learner's ``ModelStore.version``).  With a cache, the
    executed rows are padded to a :data:`BATCH_LADDER` rung kept sticky in
    ``cache.batch_floor``, so hits do not make launch shapes data-dependent.
    ``dedup=False, cache=None`` runs every submitted row, uncounted.
    """
    if samples not in SAMPLES_MODES:
        raise ValueError(f"samples={samples!r} not in {SAMPLES_MODES}")
    device = resolve_device(device)
    configs = list(configs)
    if not configs:
        return []
    B = len(configs)
    if is_scalar_load(offered_ktps):
        offered_list = [offered_ktps] * B
    else:
        offered_list = list(offered_ktps)
        if len(offered_list) != B:
            raise ValueError(
                f"offered_ktps has {len(offered_list)} entries for {B} configs"
            )
    if seeds is None:
        seeds = [params.seed] * B
    seeds = list(seeds)
    if len(seeds) != B:
        raise ValueError("seeds must match configs")
    n_ticks = int(duration_s / params.dt)
    n_ticks = (n_ticks // params.sample_every) * params.sample_every

    def run(rows: list[int], kernel_sel: str) -> list[SimResult]:
        return _run_batch(
            [configs[i] for i in rows],
            [offered_list[i] for i in rows],
            [seeds[i] for i in rows],
            n_ticks=n_ticks,
            params=params,
            min_inst_bucket=min_inst_bucket,
            min_cont_bucket=min_cont_bucket,
            devices=devices,
            min_batch_bucket=min_batch_bucket,
            tick_kernel=kernel_sel,
            min_edge_bucket=min_edge_bucket,
            min_degree_bucket=min_degree_bucket,
            resident=resident,
            samples_mode=samples,
            device=device,
        )

    if not dedup and cache is None:
        return run(list(range(B)), tick_kernel)

    # Tier 1: collapse value-identical rows before padding and stacking
    row_keys = [
        (c, _canonical_load(o), int(s))
        for c, o, s in zip(configs, offered_list, seeds)
    ]
    if dedup:
        first: dict = {}
        uniq: list[int] = []
        row_of: list[int] = []
        for i, k in enumerate(row_keys):
            j = first.get(k)
            if j is None:
                j = len(uniq)
                first[k] = j
                uniq.append(i)
            row_of.append(j)
    else:
        uniq = list(range(B))
        row_of = list(range(B))
    _DEDUP_STATS["batches"] += 1
    _DEDUP_STATS["rows_in"] += B
    _DEDUP_STATS["rows_unique"] += len(uniq)

    results_u: list = [None] * len(uniq)
    backend = tick_kernel
    full_keys = None
    if cache is not None:
        # the backend is resolved from the unique rows' unpadded maxima and
        # pinned for the executed subset, so the key's backend is the run's
        # even when hits remove the densest row
        sts = [structure_for(configs[i], params) for i in uniq]
        backend = resolve_tick_kernel(
            max(st.n_inst for st in sts),
            max(st.n_edges for st in sts),
            tick_kernel,
        )
        full_keys = [
            row_keys[i] + (params, n_ticks, backend, samples, cache_token, device.type)
            for i in uniq
        ]
        miss = []
        for j, key in enumerate(full_keys):
            hit = cache.get(key)
            if hit is None:
                miss.append(j)
            else:
                results_u[j] = hit
    else:
        miss = list(range(len(uniq)))

    _DEDUP_STATS["rows_executed"] += len(miss)
    if miss:
        rows = [uniq[j] for j in miss]
        # with a cache, pad the executed subset to its BATCH_LADDER rung,
        # sticky through the cache and capped by this call's own deduped
        # rung; replicas of the last missed row are dropped by the zip below
        pad_to = len(uniq)
        if cache is not None:
            floor = int(getattr(cache, "batch_floor", 0))
            pad_to = min(
                batch_bucket_size(len(rows), floor),
                batch_bucket_size(len(uniq)),
            )
            try:
                cache.batch_floor = max(floor, pad_to)
            except AttributeError:
                pass
        rows += [rows[-1]] * (pad_to - len(rows))
        executed = run(rows, backend)
        for j, res in zip(miss, executed):
            results_u[j] = res
            if cache is not None:
                cache.put(full_keys[j], res, _result_nbytes(res))
    return [results_u[j] for j in row_of]


def _make_refetch(config, offered, seed, n_ticks: int, params: SimParams,
                  backend: str, device: torch.device):
    """Refetch hook of one summary-backed result: re-run this row alone in
    full mode on ``device``, on the batch's resolved backend, at default
    buckets on one device, bypassing dedup and the result caches (so their
    counters never count a refetch)."""

    def refetch() -> dict:
        return _run_batch(
            [config], [offered], [seed],
            n_ticks=n_ticks, params=params,
            min_inst_bucket=0, min_cont_bucket=0, devices=1,
            min_batch_bucket=0, tick_kernel=backend,
            min_edge_bucket=0, min_degree_bucket=0, resident=False,
            samples_mode="full", device=device,
        )[0]._samples

    return refetch


def _run_batch(
    configs: list[Configuration],
    offered_list: list,
    seeds: list,
    n_ticks: int,
    params: SimParams,
    min_inst_bucket: int,
    min_cont_bucket: int,
    devices: int | None,
    min_batch_bucket: int,
    tick_kernel: str,
    min_edge_bucket: int,
    min_degree_bucket: int,
    resident: bool,
    samples_mode: str,
    device: torch.device,
) -> list[SimResult]:
    """Execute one canonicalized batch: pad, stack, stage (or take the
    resident tensors), run :func:`_simulate_core` on each shard, and bring
    the outputs to the host once, counted in :func:`transfer_info`."""
    B = len(configs)
    B_bucket = batch_bucket_size(B, min_batch_bucket) if min_batch_bucket else B
    n_dev = shard_count(B_bucket, devices, device)
    structures = [structure_for(c, params) for c in configs]
    n_inst_b = bucket_size(max(st.n_inst for st in structures), min_inst_bucket)
    n_cont_b = bucket_size(max(st.n_cont for st in structures), min_cont_bucket)
    backend = resolve_tick_kernel(
        max(st.n_inst for st in structures),
        max(st.n_edges for st in structures),
        tick_kernel,
    )
    n_edge_b = d_out_b = d_in_b = None
    if backend == "sparse":
        n_edge_b = edge_bucket_size(
            max(st.n_edges for st in structures), min_edge_bucket
        )
        d_out_b = degree_bucket_size(
            max(st.d_out for st in structures), min_degree_bucket
        )
        d_in_b = degree_bucket_size(
            max(st.d_in for st in structures), min_degree_bucket
        )

    per_tick = np.stack([_per_tick_trace(o, n_ticks, params.dt) for o in offered_list])
    # pad the batch axis up to the batch bucket, then to a multiple of the
    # shard count, by replicating the last row (dropped on unpack)
    fill = (B_bucket - B) + ((-B_bucket) % n_dev)
    rows = list(range(B)) + [B - 1] * fill
    per_dev_B = len(rows) // n_dev
    shard_devices = (
        [device] if n_dev == 1 else [torch.device("cuda", k) for k in range(n_dev)]
    )
    spans = [range(s * per_dev_B, (s + 1) * per_dev_B) for s in range(n_dev)]

    stage_key = None
    staged = None
    if resident:
        stage_key = (
            tuple(configs), params, n_inst_b, n_cont_b, n_edge_b, d_out_b,
            d_in_b, backend, n_dev, fill, str(device),
        )
        hit = _RESIDENT_CACHE.get(stage_key)
        if hit is not None:
            _RESIDENT_STATS["hits"] += 1
            _RESIDENT_CACHE.move_to_end(stage_key)
            staged = hit[0]
        else:
            _RESIDENT_STATS["misses"] += 1
    if staged is None:
        padded = [
            _padded_for(st, params, n_inst_b, n_cont_b, n_edge_b, d_out_b, d_in_b)
            for st in structures
        ]
        staged = [
            stage_padded(
                {k: np.stack([padded[rows[i]][k] for i in span]) for k in padded[0]},
                dev,
            )
            for span, dev in zip(spans, shard_devices)
        ]
        if stage_key is not None:
            _resident_put(stage_key, staged)

    _note_shape((per_dev_B, n_inst_b, n_cont_b, n_ticks, params.sample_every, n_dev,
                 backend, n_edge_b or 0, d_out_b or 0, d_in_b or 0, samples_mode))
    per_tick_in = np.asarray(per_tick[rows], np.float32)
    outs = []
    for arrays, span, dev in zip(staged, spans, shard_devices):
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            outs.append(_simulate_core(
                arrays,
                torch.as_tensor(per_tick_in[span.start:span.stop], device=dev),
                [seeds[rows[i]] for i in span],
                params,
                n_ticks=n_ticks,
                backend=backend,
                samples_mode=samples_mode,
            ))
    # one copy to the host per batch (per shard); the fill replicas stay on
    # the device
    host = []
    for o, span in zip(outs, spans):
        keep = max(0, min(B, span.stop) - span.start)
        host.append({k: v[:keep].cpu().numpy() for k, v in o.items()})
    out = {k: np.concatenate([h[k] for h in host]) for k in host[0]}
    _TRANSFER_STATS["batches"] += 1
    _TRANSFER_STATS[
        "bytes_summary" if samples_mode == "summary" else "bytes_full"
    ] += sum(int(v.nbytes) for v in out.values())

    n_samples = n_ticks // params.sample_every
    results: list[SimResult] = []
    for i, st in enumerate(structures):
        off = (
            per_tick[i, : n_samples * params.sample_every]
            .reshape(n_samples, -1)
            .mean(1)
            / params.dt
        )
        if samples_mode == "summary":
            summary = dict(
                src_half_mean=out["src_half_mean"][i],
                caputil_half_mean=out["caputil_half_mean"][i][: st.n_inst],
                sm_half_mean=out["sm_half_mean"][i][: st.n_cont],
                bp_half_mean=out["bp_half_mean"][i][: st.n_inst],
                mem_peak=out["mem_peak"][i][: st.n_inst],
                gate_final=out["gate_final"][i],
            )
            results.append(
                SimResult(
                    structure=st, params=params, offered_ktps=off,
                    summary=summary, mode="summary",
                    refetch=_make_refetch(
                        configs[i], offered_list[i], seeds[i], n_ticks,
                        params, backend, device,
                    ),
                )
            )
            continue
        si: dict = {}
        for k, v in out.items():
            vi = v[i]
            if vi.ndim == 1:                      # per-run scalar series (gate)
                si[k] = vi
            elif k in ("sm_trav", "sm_cpu"):      # per-container series
                si[k] = vi[:, : st.n_cont]
            else:                                 # per-instance series
                si[k] = vi[:, : st.n_inst]
        results.append(
            SimResult(structure=st, params=params, offered_ktps=off, samples=si)
        )
    return results


def _grid_through_batch(evaluate_batch, configs, rates_ktps):
    """Flatten the config × rate grid config-major onto the batch axis
    (config ``i`` at rate ``j`` lands at ``i * R + j``), score it with one
    ``evaluate_batch`` call, and slice back to ``out[i][j]``."""
    configs = list(configs)
    rates = [float(r) for r in rates_ktps]
    if not configs or not rates:
        return [[] for _ in configs]
    flat = evaluate_batch(
        [c for c in configs for _ in rates],
        [r for _ in configs for r in rates],
    )
    R = len(rates)
    return [flat[i * R : (i + 1) * R] for i in range(len(configs))]


def simulate_grid(
    configs: Sequence[Configuration],
    rates_ktps,
    duration_s: float = 20.0,
    params: SimParams = SimParams(),
    min_inst_bucket: int = 0,
    min_cont_bucket: int = 0,
    devices: int | None = None,
    min_batch_bucket: int = 0,
    tick_kernel: str = "auto",
    min_edge_bucket: int = 0,
    min_degree_bucket: int = 0,
    resident: bool = False,
    samples: str = "full",
    dedup: bool = True,
    cache=None,
    cache_token=None,
    device=None,
) -> list[list[SimResult]]:
    """Score C configurations × R offered rates in ONE batched run; returns
    ``out[i][j]`` for config ``i`` at ``rates_ktps[j]``."""

    def batch(flat_cfgs, flat_loads):
        return simulate_batch(
            flat_cfgs,
            flat_loads,
            duration_s=duration_s,
            params=params,
            min_inst_bucket=min_inst_bucket,
            min_cont_bucket=min_cont_bucket,
            devices=devices,
            min_batch_bucket=min_batch_bucket,
            tick_kernel=tick_kernel,
            min_edge_bucket=min_edge_bucket,
            min_degree_bucket=min_degree_bucket,
            resident=resident,
            samples=samples,
            dedup=dedup,
            cache=cache,
            cache_token=cache_token,
            device=device,
        )

    return _grid_through_batch(batch, configs, rates_ktps)


def simulate(
    config: Configuration,
    offered_ktps,
    duration_s: float = 20.0,
    params: SimParams = SimParams(),
    tick_kernel: str = "auto",
    samples: str = "full",
    cache=None,
    cache_token=None,
    device=None,
) -> SimResult:
    """Run ``config`` under ``offered_ktps`` (scalar or per-sample array);
    ``cache`` memoizes the result across calls (:func:`simulate_batch`)."""
    return simulate_batch(
        [config], [offered_ktps], duration_s, params, seeds=[params.seed],
        tick_kernel=tick_kernel, samples=samples, cache=cache,
        cache_token=cache_token, device=device,
    )[0]


def measure_capacity(
    config: Configuration,
    params: SimParams = SimParams(),
    duration_s: float = 20.0,
    overload_ktps: float = 1e6,
    tick_kernel: str = "auto",
    samples: str = "summary",
    cache=None,
    cache_token=None,
    device=None,
) -> float:
    """The 'measured rate' of a configuration: offered load far above
    capacity, backpressure gating throttles the spouts, and the steady-state
    admission is the capacity."""
    return simulate(
        config, overload_ktps, duration_s, params, tick_kernel=tick_kernel,
        samples=samples, cache=cache, cache_token=cache_token, device=device,
    ).achieved_ktps


def training_sweep(
    config: Configuration,
    rates_ktps,
    params: SimParams = SimParams(),
    seconds_per_rate: float = 10.0,
    tick_kernel: str = "auto",
    cache=None,
    cache_token=None,
    device=None,
) -> MetricsStore:
    """The paper's profiling procedure (§5.1): sweep a throttled producer
    over a range of rates with hold times and collect metrics at each
    level.  The whole ladder is one batched run; profiling consumes whole
    trajectories, so this path runs in full mode."""
    rates = [float(r) for r in rates_ktps]
    seeds = [params.seed + 1000 + i for i in range(len(rates))]
    results = simulate_batch(
        [config] * len(rates), rates, duration_s=seconds_per_rate,
        params=params, seeds=seeds, tick_kernel=tick_kernel, samples="full",
        cache=cache, cache_token=cache_token, device=device,
    )
    store = MetricsStore()
    for res in results:
        store.extend(res.to_metrics_store())
    return store
