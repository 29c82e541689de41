"""Dhalion-style reactive auto-scaler — the paper's baseline (§1, §2.3, §6).

Dhalion iterates at runtime: detect the bottleneck empirically (backpressure /
saturation), make a point modification (bump that node's parallelism, add a
container), redeploy, wait for the system to stabilize, repeat.  Convergence
takes many deploy cycles ("more than 30 minutes" for WordCount 1→4 Mtpm);
Trevor replaces the whole loop with one allocator call.

The implementation is engine-agnostic two ways:

* the classic path consumes a ``measure`` callback (usually the simulator)
  that returns the achieved rate and the saturated (bottleneck) node of a
  configuration — one real deployment per iteration;
* given a :class:`~repro_torch.streams.engine.ConfigEvaluator`, each iteration
  **speculatively evaluates the K most likely next point-modifications as
  one batch** and deploys only the winner.  The deploy-cycle count (the
  expensive quantity Dhalion pays in wall-clock) collapses, because a
  mis-attributed bottleneck no longer costs a full redeploy to discover.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Mapping

from .dag import Configuration, ContainerDim, DagSpec, round_robin_configuration

if TYPE_CHECKING:
    from ..streams.engine import ConfigEvaluator


@dataclasses.dataclass
class ReactiveStep:
    iteration: int
    parallelism: dict[str, int]
    n_containers: int
    achieved_ktps: float
    bottleneck: str | None


@dataclasses.dataclass
class ReactiveResult:
    steps: list[ReactiveStep]
    converged: bool
    final_config: Configuration
    # wall-clock estimate: every iteration costs a redeploy + stabilization
    deploy_cycle_seconds: float = 120.0

    @property
    def iterations(self) -> int:
        return len(self.steps)

    @property
    def convergence_seconds(self) -> float:
        return self.iterations * self.deploy_cycle_seconds


def _candidate_modifications(
    par: Mapping[str, int], bottleneck: str | None, k: int
) -> list[dict[str, int]]:
    """The K most likely next point-modifications, in Dhalion-resolver order:
    bump the reported bottleneck (by one, then two), the scale-everything
    resolver, then each remaining node (least-parallel first)."""
    cands: list[dict[str, int]] = []

    def add(c: dict[str, int]) -> None:
        if c not in cands:
            cands.append(c)

    if bottleneck is not None and bottleneck in par:
        add({**par, bottleneck: par[bottleneck] + 1})
        add({**par, bottleneck: par[bottleneck] + 2})
    add({n: p + 1 for n, p in par.items()})
    for n in sorted(par, key=lambda x: (par[x], x)):
        add({**par, n: par[n] + 1})
    return cands[: max(1, k)]


def speculative_step(
    dag: DagSpec,
    par: Mapping[str, int],
    bottleneck: str | None,
    evaluator: "ConfigEvaluator",
    k: int,
    dim: ContainerDim,
    instances_per_container: int,
):
    """One speculative Dhalion deploy cycle: score the K most likely point
    modifications in a single ``evaluate_batch`` and deploy the winner
    (ties broken toward the smaller total parallelism).  Returns
    ``(parallelism, config, eval_result)`` of the winner.  Shared by
    :func:`reactive_scale` and the control plane's ``ReactivePolicy`` so
    their resolvers cannot diverge."""
    cands = _candidate_modifications(par, bottleneck, k)
    cfgs = [_pack(dag, c, dim, instances_per_container) for c in cands]
    evals = evaluator.evaluate_batch(cfgs)
    best = max(
        range(len(cands)),
        key=lambda i: (evals[i].achieved_ktps, -sum(cands[i].values())),
    )
    return dict(cands[best]), cfgs[best], evals[best]


def reactive_scale(
    dag: DagSpec,
    target_ktps: float,
    measure: Callable[[Configuration], tuple[float, str | None]] | None = None,
    initial_parallelism: Mapping[str, int] | None = None,
    dim: ContainerDim = ContainerDim(),
    max_iterations: int = 64,
    instances_per_container: int = 2,
    deploy_cycle_seconds: float = 120.0,
    evaluator: "ConfigEvaluator | None" = None,
    speculative_k: int = 4,
) -> ReactiveResult:
    """Iteratively scale until ``target_ktps`` is reached or iterations run out.

    Policy (mirrors Dhalion's resolvers): if a bottleneck node is reported,
    increase that node's parallelism by one; otherwise increase every node
    (the unknown-bottleneck resolver).  Containers grow to keep at most
    ``instances_per_container`` instances per container.

    With an ``evaluator``, each iteration instead scores ``speculative_k``
    candidate point-modifications in one batch and deploys the best — see
    the module docstring.  One of ``measure`` / ``evaluator`` is required.
    """
    if measure is None and evaluator is None:
        raise ValueError("reactive_scale needs a measure callback or an evaluator")
    if measure is None:
        assert evaluator is not None

        def measure(cfg: Configuration) -> tuple[float, str | None]:
            r = evaluator.evaluate(cfg)
            return r.achieved_ktps, r.bottleneck

    par = dict(initial_parallelism or {n: 1 for n in dag.node_names})
    steps: list[ReactiveStep] = []
    converged = False
    cfg = _pack(dag, par, dim, instances_per_container)
    pending: tuple[float, str | None] | None = None
    for it in range(max_iterations):
        if pending is None:
            achieved, bottleneck = measure(cfg)
        else:
            achieved, bottleneck = pending   # winner of last speculative batch
            pending = None
        steps.append(
            ReactiveStep(it, dict(par), cfg.n_containers, achieved, bottleneck)
        )
        if achieved >= target_ktps:
            converged = True
            break
        if evaluator is not None and speculative_k > 1:
            par, cfg, ev_best = speculative_step(
                dag, par, bottleneck, evaluator, speculative_k, dim,
                instances_per_container,
            )
            pending = (ev_best.achieved_ktps, ev_best.bottleneck)
            continue
        # point modification: bump the bottleneck (or everything, if unknown)
        if bottleneck is not None and bottleneck in par:
            par[bottleneck] += 1
        else:
            for n in par:
                par[n] += 1
        cfg = _pack(dag, par, dim, instances_per_container)
    if pending is not None and not converged:
        # the last speculative batch already measured the deployed winner —
        # record it instead of dropping the measurement on loop exhaustion
        achieved, bottleneck = pending
        steps.append(
            ReactiveStep(len(steps), dict(par), cfg.n_containers, achieved, bottleneck)
        )
        converged = achieved >= target_ktps
    return ReactiveResult(
        steps=steps,
        converged=converged,
        final_config=cfg,
        deploy_cycle_seconds=deploy_cycle_seconds,
    )


def _pack(
    dag: DagSpec,
    par: Mapping[str, int],
    dim: ContainerDim,
    instances_per_container: int,
) -> Configuration:
    total = sum(par.values())
    n_containers = max(1, -(-total // instances_per_container))
    return round_robin_configuration(dag, par, n_containers, dim)
