"""Model-based edge allocator (Trevor §3.2, fig. 10).

Given per-node learned models and a declared target source rate, produce an
efficient physical configuration in closed form — no search over the
configuration space:

1. Propagate the target rate through the DAG with learned γ's to get the
   required input rate of every node.
2. Group nodes by *alternate edges* in topological order, pairing each node
   with its heaviest unassigned downstream neighbor (compute-cost weighted) —
   co-locating communicating nodes for data locality.
3. For each group, compose a **balanced container**: instance counts such
   that every node operates at capacity AND the stream manager is
   rate-matched at one full CPU under the worst-case traversal factor — in
   the limit of many containers essentially all pair traffic crosses
   containers, so an edge (u→v) container ingesting ρ sees SM traversals
   ``ρ·(1 + 2γᵤ + γᵤγᵥ)`` (= 4ρ when γ=1: the paper's "S will need to pass a
   rate 4R in the limit").
4. Optionally scale each balanced container by α ≤ 1 to a preferred
   container dimension.
5. Replicate each (α-scaled) container to the count required for the target
   rate on its edge.

Complexity: O(|V| + |E|).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Sequence

from .dag import Configuration, ContainerDim, DagSpec, propagate_rates
from .metrics import STREAM_MANAGER
from .node_model import NodeModel


@dataclasses.dataclass
class BalancedContainer:
    """One balanced-container template before replication."""

    nodes: tuple[str, ...]               # 1 (singleton) or 2 (edge) node names
    counts: dict[str, int]               # instances of each node per container
    rate_ktps: float                     # input rate (of nodes[0]) one container absorbs
    dim: ContainerDim
    sm_traversal_factor: float           # worst-case SM traversals per unit input rate
    replicas: int = 1


@dataclasses.dataclass
class AllocationResult:
    config: Configuration
    templates: list[BalancedContainer]
    target_rate_ktps: float
    predicted_node_rates: dict[str, float]
    total_cpus: float
    total_mem_mb: float


def _traversal_factor(
    gammas: Sequence[float],
    u_is_source: bool = False,
    v_has_consumers: bool = True,
) -> float:
    """Worst-case SM traversals per unit container-input-rate for a group.

    For an interior pair (u, v): ingress ρ + u's output origination γᵤρ +
    v's share arriving from the network γᵤρ + v's output origination γᵤγᵥρ
    → 1 + 2γᵤ + γᵤγᵥ (the paper's 4R limit at γ = 1).  Two refinements keep
    the bound tight where the generic one over-provisions ~2×:
    * a *source* u ingests from the spout directly, not through the SM
      (drop the ingress term),
    * a terminal v (no downstream consumers) emits nothing (drop γᵤγᵥ).
    For a singleton (u,): ingress + origination.
    """
    if len(gammas) == 1:
        base = 0.0 if u_is_source else 1.0
        return max(base + gammas[0], 0.25)
    gu, gv = gammas
    phi = (0.0 if u_is_source else 1.0) + 2.0 * gu
    if v_has_consumers:
        phi += gu * gv
    return max(phi, 0.25)


def _pair_nodes(
    dag: DagSpec, models: Mapping[str, NodeModel], rates: Mapping[str, float]
) -> list[tuple[str, ...]]:
    """Group nodes by alternate edges in topological order (fig. 10): each
    unassigned node pairs with its heaviest (compute cost at required rate)
    unassigned downstream neighbor; leftovers become singletons."""
    assigned: set[str] = set()
    groups: list[tuple[str, ...]] = []
    for u in dag.topological_order():
        if u in assigned:
            continue
        best, best_w = None, -1.0
        for e in dag.out_edges(u):
            v = e.dst
            if v in assigned:
                continue
            w = models[v].busy_cost_per_ktps * rates[v]
            if w > best_w:
                best, best_w = v, w
        if best is not None:
            groups.append((u, best))
            assigned.update((u, best))
        else:
            groups.append((u,))
            assigned.add(u)
    return groups


def compose_balanced_container(
    group: tuple[str, ...],
    models: Mapping[str, NodeModel],
    group_rates: Mapping[str, float],
    max_instances_per_node: int = 64,
    mem_headroom: float = 1.1,
    dag: DagSpec | None = None,
    rounding: str = "ceil",
) -> BalancedContainer:
    """Rate-match the group's nodes to a stream manager at one full CPU.

    ``rounding`` picks how fractional instance requirements become counts:
    ``"ceil"`` (the paper's conservative default) or ``"floor"`` (a leaner
    candidate whose feasibility an evaluator can check empirically).
    """
    sm = models[STREAM_MANAGER]
    gammas = [models[n].gamma for n in group]
    u_is_source = False
    v_has_consumers = True
    if dag is not None:
        u_is_source = group[0] in {s.name for s in dag.sources()}
        v_has_consumers = bool(dag.out_edges(group[-1]))
    phi = _traversal_factor(gammas, u_is_source, v_has_consumers)
    # SM at one full CPU processes its peak rate; the container's input rate
    # is bounded by R_sm / phi (rate-matching point, §3.2).
    rho = sm.peak_rate_ktps / phi

    # Relative input rate of each node in the group (second node of a pair
    # sees gamma_u * rho).
    rel = {group[0]: 1.0}
    if len(group) == 2:
        rel[group[1]] = gammas[0]

    round_up = rounding != "floor"
    counts: dict[str, int] = {}
    for nm in group:
        need = rho * rel[nm] / models[nm].peak_rate_ktps
        n = math.ceil(need - 1e-9) if round_up else math.floor(need + 1e-9)
        counts[nm] = max(1, min(max_instances_per_node, n))
    # If ceil() left headroom on every node, rho is still SM-limited: keep it.
    # Floored counts may under-provision a node, so the container's
    # sustainable rate drops to the slowest node's capacity (more replicas
    # compensate at the allocation level).
    if not round_up:
        rho = min(
            [rho]
            + [
                counts[nm] * models[nm].peak_rate_ktps / rel[nm]
                for nm in group
                if rel[nm] > 0  # a zero-gamma-fed node absorbs no rate
            ]
        )
    cpus = sum(
        counts[nm] * models[nm].cpu_at(rho * rel[nm] / counts[nm]) for nm in group
    )
    cpus += 1.0  # the rate-matched stream manager at one full CPU
    mem = sum(
        counts[nm] * models[nm].mem_at(rho * rel[nm] / counts[nm]) for nm in group
    )
    mem = (mem + sm.mem_base_mb) * mem_headroom
    return BalancedContainer(
        nodes=group,
        counts=counts,
        rate_ktps=rho,
        dim=ContainerDim(cpus=max(cpus, 0.5), mem_mb=max(mem, 256.0)),
        sm_traversal_factor=phi,
    )


def _alpha_scale(bc: BalancedContainer, preferred: ContainerDim) -> BalancedContainer:
    """Scale a balanced container by α ≤ 1 to a preferred dimension (§3.2)."""
    alpha = min(1.0, preferred.cpus / bc.dim.cpus, preferred.mem_mb / bc.dim.mem_mb)
    if alpha >= 1.0:
        return bc
    counts = {n: max(1, math.ceil(c * alpha)) for n, c in bc.counts.items()}
    rate = bc.rate_ktps * alpha
    return BalancedContainer(
        nodes=bc.nodes,
        counts=counts,
        rate_ktps=rate,
        dim=ContainerDim(
            cpus=min(preferred.cpus, bc.dim.cpus),
            mem_mb=min(preferred.mem_mb, bc.dim.mem_mb),
            link_mbps=preferred.link_mbps,
        ),
        sm_traversal_factor=bc.sm_traversal_factor,
    )


def _allocate_one(
    dag: DagSpec,
    models: Mapping[str, NodeModel],
    target_rate_ktps: float,
    preferred_dim: ContainerDim | None,
    overprovision: float,
    rounding: str = "ceil",
) -> AllocationResult:
    """One closed-form allocation for a fixed preferred dim and rounding."""
    rate = target_rate_ktps * overprovision
    gammas = {n: models[n].gamma for n in dag.node_names}
    node_rates = propagate_rates(dag, rate, gammas)

    groups = _pair_nodes(dag, models, node_rates)
    templates: list[BalancedContainer] = []
    packing: list[tuple[str, ...]] = []
    dims: list[ContainerDim] = []
    for group in groups:
        bc = compose_balanced_container(
            group, models, node_rates, dag=dag, rounding=rounding
        )
        if preferred_dim is not None:
            bc = _alpha_scale(bc, preferred_dim)
        required = node_rates[group[0]]
        bc.replicas = max(1, math.ceil(required / max(bc.rate_ktps, 1e-9) - 1e-9))
        templates.append(bc)
        pack: list[str] = []
        for nm in group:
            pack.extend([nm] * bc.counts[nm])
        for _ in range(bc.replicas):
            packing.append(tuple(pack))
            dims.append(bc.dim)

    config = Configuration(dag=dag, packing=tuple(packing), dims=tuple(dims))
    return AllocationResult(
        config=config,
        templates=templates,
        target_rate_ktps=target_rate_ktps,
        predicted_node_rates=node_rates,
        total_cpus=config.total_cpus(),
        total_mem_mb=config.total_mem_mb(),
    )


def allocate_point(
    dag: DagSpec,
    models: Mapping[str, NodeModel],
    target_rate_ktps: float,
    preferred_dim: ContainerDim | None = None,
    overprovision: float = 1.0,
    rounding: str = "ceil",
) -> AllocationResult:
    """One closed-form allocation at a single (dim, rounding) point.

    Args:
        dag: the logical job.
        models: learned per-node models (including the stream manager).
        target_rate_ktps: declared source rate to provision for.
        preferred_dim: optional container dimension to α-scale down to.
        overprovision: §4 calibration factor multiplied into the rate.
        rounding: ``"ceil"`` (conservative, the paper's default) or
            ``"floor"`` (a leaner candidate whose feasibility an evaluator
            can check empirically).

    Returns:
        The :class:`AllocationResult` for exactly this point — no candidate
        search.  The fleet scheduler uses this to build per-tenant candidate
        *sets* (dim × rounding ladders) that are then scored together in one
        batched evaluation.
    """
    if target_rate_ktps <= 0:
        raise ValueError("target rate must be positive")
    return _allocate_one(
        dag, models, target_rate_ktps, preferred_dim, overprovision, rounding
    )


def minimal_footprint(
    dag: DagSpec,
    models: Mapping[str, NodeModel],
    preferred_dim: ContainerDim | None = None,
    overprovision: float = 1.0,
) -> Configuration:
    """The smallest configuration this DAG can run as: one container per
    node group with one instance of each node (the rate → 0 limit).

    This is the *minimum footprint* admission is judged by: a tenant whose
    minimal configuration does not bin-pack onto the remaining inventory
    cannot be admitted at any rate — and it is the trial-pack probe the
    fleet scheduler's preemption ladder tries to make room for."""
    return _allocate_one(
        dag, models, 1e-3, preferred_dim, overprovision, "ceil"
    ).config


def allocate(
    dag: DagSpec,
    models: Mapping[str, NodeModel],
    target_rate_ktps: float,
    preferred_dim: ContainerDim | None = None,
    candidate_dims: Sequence[ContainerDim] | None = None,
    overprovision: float = 1.0,
    evaluator=None,
) -> AllocationResult:
    """The Trevor allocator: declared target rate -> physical configuration.

    ``overprovision`` is the calibration factor from §4 (e.g. 1.09 when the
    flow solver over-predicts by 9%); ``candidate_dims`` optionally searches a
    small set of preferred container dimensions (the paper's policy knob).

    With an ``evaluator`` (any object whose ``evaluate_batch(configs)``
    returns results carrying ``achieved_ktps``), every (dim × rounding)
    candidate is scored empirically in ONE ``evaluate_batch`` call, and the cheapest configuration whose *measured*
    capacity meets the target wins — model error can no longer pick an
    infeasible "optimal".  Without one, the closed-form analytic choice is
    returned (the paper's behavior).
    """
    if target_rate_ktps <= 0:
        raise ValueError("target rate must be positive")

    if evaluator is not None:
        dims: list[ContainerDim | None] = (
            list(candidate_dims) if candidate_dims else [preferred_dim]
        )
        candidates: list[AllocationResult] = []
        seen: set[tuple] = set()
        for dim in dims:
            for rounding in ("ceil", "floor"):
                res = _allocate_one(
                    dag, models, target_rate_ktps, dim, overprovision, rounding
                )
                key = (res.config.packing, res.config.dims)
                if key not in seen:
                    seen.add(key)
                    candidates.append(res)
        evals = evaluator.evaluate_batch([c.config for c in candidates])
        feasible = [
            c for c, e in zip(candidates, evals)
            if e.achieved_ktps >= target_rate_ktps
        ]
        if feasible:
            return min(feasible, key=lambda c: c.total_cpus)
        # nothing measured feasible (model error larger than the rounding
        # slack): return the candidate that got closest to the target
        return max(
            zip(candidates, evals), key=lambda ce: ce[1].achieved_ktps
        )[0]

    if candidate_dims:
        best: AllocationResult | None = None
        for dim in candidate_dims:
            res = _allocate_one(
                dag, models, target_rate_ktps, dim, overprovision
            )
            if best is None or res.total_cpus < best.total_cpus:
                best = res
        assert best is not None
        return best

    return _allocate_one(
        dag, models, target_rate_ktps, preferred_dim, overprovision
    )


# ---------------------------------------------------------------------------
# Budget-constrained allocation (the fleet scheduler's per-tenant primitive)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResourceBudget:
    """A cap on what one allocation may consume: CPUs, memory, containers."""

    cpus: float = float("inf")
    mem_mb: float = float("inf")
    containers: int | None = None

    def admits(self, config: Configuration) -> bool:
        if config.total_cpus() > self.cpus + 1e-9:
            return False
        if config.total_mem_mb() > self.mem_mb + 1e-6:
            return False
        if self.containers is not None and config.n_containers > self.containers:
            return False
        return True


@dataclasses.dataclass
class BudgetedAllocation:
    """The best feasible point under a budget, and how far it falls short.

    ``fits`` is False only when even the *minimal* allocation (one container
    per group at near-zero rate) violates the budget — the tenant cannot be
    admitted at all.  Otherwise ``result`` allocates for
    ``feasible_rate_ktps`` (= the target when the budget does not bind) and
    ``shortfall_ktps`` is the demanded rate the budget could not buy.
    """

    result: AllocationResult
    target_rate_ktps: float
    feasible_rate_ktps: float
    shortfall_ktps: float
    fits: bool

    @property
    def degraded(self) -> bool:
        return self.shortfall_ktps > 1e-9 or not self.fits


def allocate_under_budget(
    dag: DagSpec,
    models: Mapping[str, NodeModel],
    target_rate_ktps: float,
    budget: ResourceBudget,
    preferred_dim: ContainerDim | None = None,
    overprovision: float = 1.0,
    rounding: str = "ceil",
    fits: "Callable[[Configuration], bool] | None" = None,
    rate_tol: float = 0.01,
    max_bisections: int = 32,
) -> BudgetedAllocation:
    """Closed-form allocation under a resource cap (fleet scheduling mode).

    When the unconstrained allocation for the target fits the budget it is
    returned with zero shortfall.  Otherwise the rate is bisected to the
    largest value whose allocation the budget admits — allocation cost is a
    monotone step function of rate, so bisection lands on the best feasible
    point within ``rate_tol`` relative to the feasible rate itself (not the
    demanded target, so an extravagant ask still resolves its small feasible
    point precisely).  ``fits`` adds an arbitrary extra
    feasibility predicate on the produced configuration (the fleet scheduler
    passes a trial bin-packing against the remaining host inventory, so
    fragmentation — not just aggregate capacity — binds the allocation).
    """
    if target_rate_ktps <= 0:
        raise ValueError("target rate must be positive")

    def admitted(res: AllocationResult) -> bool:
        return budget.admits(res.config) and (fits is None or fits(res.config))

    def alloc(rate: float) -> AllocationResult:
        return _allocate_one(dag, models, rate, preferred_dim, overprovision, rounding)

    full = alloc(target_rate_ktps)
    if admitted(full):
        return BudgetedAllocation(
            result=full,
            target_rate_ktps=target_rate_ktps,
            feasible_rate_ktps=target_rate_ktps,
            shortfall_ktps=0.0,
            fits=True,
        )

    # the smallest allocation this DAG admits: one container per group with
    # one instance of each node (rate -> 0 collapses every count to 1).
    # The probe rate is target-independent: whether a tenant fits *at all*
    # must not depend on how much it asked for.
    floor_rate = min(1e-3, target_rate_ktps)
    floor = alloc(floor_rate)
    if not admitted(floor):
        return BudgetedAllocation(
            result=floor,
            target_rate_ktps=target_rate_ktps,
            feasible_rate_ktps=0.0,
            shortfall_ktps=target_rate_ktps,
            fits=False,
        )

    lo, best = floor_rate, floor
    hi = target_rate_ktps
    for _ in range(max_bisections):
        if hi - lo <= rate_tol * hi:
            break
        mid = 0.5 * (lo + hi)
        res = alloc(mid)
        if admitted(res):
            lo, best = mid, res
        else:
            hi = mid
    return BudgetedAllocation(
        result=best,
        target_rate_ktps=target_rate_ktps,
        feasible_rate_ktps=lo,
        shortfall_ktps=max(target_rate_ktps - lo, 0.0),
        fits=True,
    )
