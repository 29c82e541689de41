"""The scaling brains, as interchangeable control-plane policies.

Each policy answers one question — *what should be deployed for this
target?* — and nothing else: sensing, guard bands, measurement and learning
live in :class:`~repro_torch.control.loop.ControlLoop`.

* :class:`DeclarativePolicy` — Trevor's one-shot model-based allocation
  (fig. 2b), behind ``AutoScaler.configure_for``;
* :class:`ReactivePolicy` — the Dhalion-style speculative K-candidate
  iterator of ``reactive_scale``;
* :class:`HybridPolicy` — model-based target, reactive trim: allocate in
  closed form, then empirically verify the capacity and clone the container
  hosting the measured bottleneck until the target is met.  One-shot speed
  with Dhalion's empirical safety net — the configuration model error can
  no longer strand an allocation below target;
* :class:`PredictivePolicy` — horizon planning: consume the loop's
  forecast window and deploy the cheapest configuration empirically
  feasible for the *whole* window, scored as one batched
  candidates × horizon-rates sweep;
* :class:`ElasticLMPolicy` — the ``lm_bridge`` card planner: loads are
  tokens/s, the provisioned capacity is cards.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from ..core.allocator import allocate
from ..core.dag import Configuration, ContainerDim, DagSpec
from ..core.lm_bridge import LMAllocation, LMWorkloadModel, allocate_chips
from ..core.node_model import NodeModel
from ..core.reactive import _pack, speculative_step
from .learning import ModelStore
from .loop import Action, ControlContext


def _as_store(models: "ModelStore | Mapping[str, NodeModel]") -> ModelStore:
    if isinstance(models, ModelStore):
        return models
    return ModelStore(models)


class DeclarativePolicy:
    """One-shot model-based allocation (Trevor fig. 2b, §3.2).

    Plans by calling the closed-form allocator with the store's current
    models and over-provisioning factor.  With ``score_with_evaluator``,
    the allocator's (dim × rounding) candidates are additionally scored
    empirically through the loop's evaluator in one batch.
    """

    name = "declarative"

    def __init__(
        self,
        dag: DagSpec,
        models: "ModelStore | Mapping[str, NodeModel]",
        preferred_dim: ContainerDim | None = None,
        candidate_dims=None,
        score_with_evaluator: bool = False,
    ) -> None:
        self.dag = dag
        self.store = _as_store(models)
        self.preferred_dim = preferred_dim
        self.candidate_dims = candidate_dims
        self.score_with_evaluator = score_with_evaluator

    def plan(self, target: float, ctx: ControlContext) -> Action:
        res = allocate(
            self.dag,
            self.store.models,
            target,
            preferred_dim=self.preferred_dim,
            candidate_dims=self.candidate_dims,
            overprovision=self.store.overprovision_factor,
            evaluator=ctx.evaluator if self.score_with_evaluator else None,
        )
        return Action(
            provisioned=res.total_cpus,
            predicted_capacity=target,   # allocation is rate-matched to the target
            config=res.config,
            detail=res,
            reason="allocate",
        )


class ReactivePolicy:
    """Dhalion-style reactive iteration as a policy (the paper's baseline).

    Stateful: carries the per-node parallelism between plans.  Each
    :meth:`plan` measures the current configuration's capacity, then runs
    speculative deploy cycles — ``speculative_k`` candidate point
    modifications scored per cycle in ONE ``evaluate_batch`` — until the
    measured capacity reaches the target (or ``max_cycles_per_plan`` runs
    out).  ``cycles`` accumulates the Dhalion cost metric: every cycle is a
    redeploy + stabilization in the real system.
    """

    name = "reactive"

    def __init__(
        self,
        dag: DagSpec,
        dim: ContainerDim = ContainerDim(),
        initial_parallelism: Mapping[str, int] | None = None,
        instances_per_container: int = 2,
        speculative_k: int = 4,
        max_cycles_per_plan: int = 16,
    ) -> None:
        self.dag = dag
        self.dim = dim
        self.par = dict(initial_parallelism or {n: 1 for n in dag.node_names})
        self.instances_per_container = instances_per_container
        self.speculative_k = speculative_k
        self.max_cycles_per_plan = max_cycles_per_plan
        self.cycles = 0

    def plan(self, target: float, ctx: ControlContext) -> Action:
        ev = ctx.evaluator
        if ev is None:
            raise ValueError("ReactivePolicy needs the loop to have an evaluator")
        cfg = _pack(self.dag, self.par, self.dim, self.instances_per_container)
        probe = ev.evaluate(cfg)         # capacity probe (overload)
        self.cycles += 1
        for _ in range(self.max_cycles_per_plan):
            if probe.achieved_ktps >= target:
                break
            self.par, cfg, probe = speculative_step(
                self.dag, self.par, probe.bottleneck, ev, self.speculative_k,
                self.dim, self.instances_per_container,
            )
            self.cycles += 1
        return Action(
            provisioned=cfg.total_cpus(),
            predicted_capacity=probe.achieved_ktps,   # empirical, not model-based
            config=cfg,
            detail={"parallelism": dict(self.par), "cycles": self.cycles},
            reason="reactive",
            measurement=probe,             # spare the loop a re-measure
        )


class HybridPolicy:
    """Model-based target + reactive trim (new with the control plane).

    Allocates in closed form like :class:`DeclarativePolicy`, then — when
    the loop has an evaluator — measures the allocation's capacity and, if
    it falls short of the target, speculatively clones containers (the one
    hosting the measured bottleneck first) until the target is met.  The
    model provides the jump, the measurement provides the guarantee.
    """

    name = "hybrid"

    def __init__(
        self,
        dag: DagSpec,
        models: "ModelStore | Mapping[str, NodeModel]",
        preferred_dim: ContainerDim | None = None,
        speculative_k: int = 4,
        max_trims: int = 4,
    ) -> None:
        self.dag = dag
        self.store = _as_store(models)
        self.preferred_dim = preferred_dim
        self.speculative_k = speculative_k
        self.max_trims = max_trims
        self.trims = 0

    @staticmethod
    def _clone_candidates(
        cfg: Configuration, bottleneck: str | None, k: int
    ) -> list[Configuration]:
        """Candidate configurations: duplicate one container each.  The
        containers hosting the bottleneck node come first; identical
        (packing, dim) templates are deduplicated."""
        order = sorted(
            range(cfg.n_containers),
            key=lambda i: (bottleneck not in cfg.packing[i]) if bottleneck else False,
        )
        seen: set[tuple] = set()
        out: list[Configuration] = []
        for i in order:
            key = (cfg.packing[i], cfg.dims[i])
            if key in seen:
                continue
            seen.add(key)
            out.append(
                Configuration(
                    dag=cfg.dag,
                    packing=cfg.packing + (cfg.packing[i],),
                    dims=cfg.dims + (cfg.dims[i],),
                )
            )
            if len(out) >= k:
                break
        return out

    def plan(self, target: float, ctx: ControlContext) -> Action:
        res = allocate(
            self.dag,
            self.store.models,
            target,
            preferred_dim=self.preferred_dim,
            overprovision=self.store.overprovision_factor,
        )
        cfg = res.config
        if ctx.evaluator is None:
            return Action(
                provisioned=res.total_cpus,
                predicted_capacity=target,
                config=cfg,
                detail=res,
                reason="allocate",
            )
        probe = ctx.evaluator.evaluate(cfg)
        trims = 0
        while probe.achieved_ktps < target and trims < self.max_trims:
            cands = self._clone_candidates(cfg, probe.bottleneck, self.speculative_k)
            if not cands:
                break
            evals = ctx.evaluator.evaluate_batch(cands)
            best = max(range(len(cands)), key=lambda i: evals[i].achieved_ktps)
            cfg, probe = cands[best], evals[best]
            trims += 1
            self.trims += 1
        return Action(
            provisioned=cfg.total_cpus(),
            predicted_capacity=probe.achieved_ktps,
            config=cfg,
            detail={"allocation": res, "trims": trims},
            reason="allocate+trim" if trims else "allocate",
            measurement=probe,             # spare the loop a re-measure
        )


class PredictivePolicy:
    """Horizon planning: the cheapest configuration feasible for the WHOLE
    forecast window (new with the forecast phase).

    Where :class:`DeclarativePolicy` plans for the instantaneous target and
    :class:`HybridPolicy` trims after the fact, this policy consumes the
    loop's forecast window (:attr:`PlanContext.horizon`) and answers for
    every step of it at once:

    1. build a small ladder of closed-form allocations spanning the
       window's target range (cheapest plausible → peak), padded by
       replication to a FIXED candidate count so every plan call issues
       the same batch shape — one launch shape serves the whole trace,
    2. score candidates × window rates in ONE batched evaluator call
       (:func:`~repro_torch.streams.engine.evaluate_grid_with`; the rates ride
       the batch axis and reuse the sticky shape buckets) — the
       sweep reads only ``achieved_ktps``, so under a summary-mode
       evaluator (the default) the whole grid transfers O(candidates)
       summary bytes instead of every candidate's trajectory,
    3. deploy the cheapest candidate whose measured rate keeps up at
       EVERY window step; if none survives, the candidate with the best
       worst-step margin.

    Without a forecast window (or an evaluator) it degrades to the
    declarative horizon-1 allocation.  The winning candidate's score at the
    *current* load doubles as the loop's measurement (no second
    deploy+measure cycle per step).
    """

    name = "predictive"

    def __init__(
        self,
        dag: DagSpec,
        models: "ModelStore | Mapping[str, NodeModel]",
        preferred_dim: ContainerDim | None = None,
        n_candidates: int = 4,
        feasibility_threshold: float = 0.98,
    ) -> None:
        self.dag = dag
        self.store = _as_store(models)
        self.preferred_dim = preferred_dim
        self.n_candidates = max(1, int(n_candidates))
        self.feasibility_threshold = float(feasibility_threshold)

    def _candidates(self, window_targets: np.ndarray) -> list:
        """Closed-form allocations along the window's target range, deduped
        by configuration and padded by replicating the costliest entry so
        the scored batch always holds exactly ``n_candidates`` entries
        (a stable batch shape is a stable launch shape)."""
        lo = float(np.min(window_targets))
        hi = float(np.max(window_targets))
        ladder = (
            np.linspace(lo, hi, self.n_candidates)
            if hi > lo
            else np.full(self.n_candidates, hi)
        )
        cands, seen = [], set()
        for t in ladder:
            res = allocate(
                self.dag,
                self.store.models,
                max(float(t), 1e-6),
                preferred_dim=self.preferred_dim,
                overprovision=self.store.overprovision_factor,
            )
            key = (res.config.packing, res.config.dims)
            if key in seen:
                continue
            seen.add(key)
            cands.append(res)
        while len(cands) < self.n_candidates:
            cands.append(cands[-1])
        return cands

    def plan(self, target: float, ctx: ControlContext) -> Action:
        window_loads = ctx.window_loads()
        window_targets = ctx.window_targets()
        cands = self._candidates(window_targets)
        if ctx.evaluator is None:
            # no measurement channel: trust the model at the window peak
            res = max(cands, key=lambda r: r.total_cpus)
            return Action(
                provisioned=res.total_cpus,
                predicted_capacity=float(np.max(window_targets)),
                config=res.config,
                detail=res,
                reason="forecast-allocate",
            )
        from ..streams.engine import evaluate_grid_with

        grid = evaluate_grid_with(
            ctx.evaluator, [r.config for r in cands], window_loads
        )
        thr = self.feasibility_threshold
        margins = []                  # per candidate: worst-step achieved/load
        for row in grid:
            margins.append(
                min(
                    e.achieved_ktps / max(l, 1e-9)
                    for e, l in zip(row, window_loads)
                )
            )
        feasible = [i for i, m in enumerate(margins) if m >= thr]
        if feasible:
            best = min(feasible, key=lambda i: cands[i].total_cpus)
        else:
            best = int(np.argmax(margins))
        res, row = cands[best], grid[best]
        return Action(
            provisioned=res.total_cpus,
            # the best lower bound on capacity this sweep produced: the
            # largest rate the winner was seen to sustain
            predicted_capacity=float(max(e.achieved_ktps for e in row)),
            config=res.config,
            detail={
                "allocation": res,
                "window_loads": window_loads,
                "worst_step_margin": margins[best],
                "n_feasible": len(feasible),
            },
            reason="horizon" if len(window_loads) > 1 else "allocate",
            measurement=row[0],        # scored at the current load
        )


class ElasticLMPolicy:
    """The LM card planner as a policy: loads are tokens/s, provisioned
    capacity is cards (the reference's TPU chips), and the closed-form
    ``allocate_chips`` plays the allocator.  No evaluator: the learned
    roofline model is the sensor."""

    name = "elastic-lm"

    def __init__(
        self,
        model: LMWorkloadModel,
        tokens_per_step: int,
        min_chips: int = 8,
        max_chips: int = 4096,
        overlap: float = 0.0,
    ) -> None:
        self.model = model
        self.tokens_per_step = tokens_per_step
        self.min_chips = min_chips
        self.max_chips = max_chips
        self.overlap = overlap

    def plan(self, target: float, ctx: ControlContext) -> Action:
        alloc = allocate_chips(
            self.model,
            target,
            self.tokens_per_step,
            overlap=self.overlap,
            max_chips=self.max_chips,
        )
        chips = max(self.min_chips, min(alloc.chips, self.max_chips))
        if chips != alloc.chips:
            alloc = LMAllocation(
                chips=chips,
                predicted_tokens_per_s=self.model.tokens_per_second(
                    self.tokens_per_step, chips, self.overlap
                ),
                predicted_step_s=self.model.step_seconds(
                    self.tokens_per_step, chips, self.overlap
                ),
                bottleneck=alloc.bottleneck,
                target_tokens_per_s=alloc.target_tokens_per_s,
            )
        return Action(
            provisioned=float(chips),
            predicted_capacity=alloc.predicted_tokens_per_s,
            config=None,
            detail=alloc,
            reason="remesh",
        )
