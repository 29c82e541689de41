"""Elastic scaling: Trevor's declarative allocator driving GPU capacity, a
thin controller over the unified control plane, as in the reference
package.

The controller watches the serving/training load (tokens/sec) and emits
re-mesh decisions in closed form.  The brain is
:class:`~repro_torch.control.policies.ElasticLMPolicy` (``lm_bridge`` cost
models with the H100's rates instead of cputil fits) and the
deadband/hysteresis guards are the shared
:class:`~repro_torch.control.loop.GuardBands` — the same semantics every
other policy gets.  Checkpoints (``repro_torch.checkpoint``) make the
re-mesh executable: restart with the new card count and restore.

:class:`FleetElasticController` extends the same observe() idiom to many
stream tenants sharing one finite cluster (:mod:`repro_torch.fleet`): a
re-mesh becomes a fleet reschedule.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Mapping, Sequence

from ..core.lm_bridge import LMAllocation, LMWorkloadModel

if TYPE_CHECKING:
    from ..fleet import Cluster, FleetEvent, FleetPlan, TenantSpec
    from ..streams.engine import ConfigEvaluator


@dataclasses.dataclass
class ElasticEvent:
    load_tokens_per_s: float
    chips_before: int
    chips_after: int
    reason: str


class ElasticController:
    """Deadband-controlled card-count planner (one per served model).
    ``chips`` counts cards, under the reference's name."""

    def __init__(
        self,
        model: LMWorkloadModel,
        tokens_per_step: int,
        headroom: float = 1.25,
        deadband: float = 0.2,
        min_chips: int = 8,
        max_chips: int = 4096,
        on_remesh: Callable[[ElasticEvent], None] | None = None,
        forecaster=None,
        horizon: int = 4,
    ):
        from ..control.loop import ControlLoop, GuardBands
        from ..control.policies import ElasticLMPolicy

        self.chips = min_chips
        self.events: list[ElasticEvent] = []
        self.on_remesh = on_remesh
        self.loop = ControlLoop(
            ElasticLMPolicy(
                model, tokens_per_step, min_chips=min_chips, max_chips=max_chips
            ),
            guards=GuardBands(headroom=headroom, deadband=deadband),
            # optional forecast phase: re-mesh for the window-peak token rate
            forecaster=forecaster,
            horizon=horizon,
        )

    # -- tunables forwarded live to the loop/policy (not captured copies) ---
    @property
    def model(self) -> LMWorkloadModel:
        return self.loop.policy.model

    @model.setter
    def model(self, m: LMWorkloadModel) -> None:
        self.loop.policy.model = m

    @property
    def tokens_per_step(self) -> int:
        return self.loop.policy.tokens_per_step

    @tokens_per_step.setter
    def tokens_per_step(self, n: int) -> None:
        self.loop.policy.tokens_per_step = n

    @property
    def headroom(self) -> float:
        return self.loop.guards.headroom

    @headroom.setter
    def headroom(self, v: float) -> None:
        self.loop.guards = dataclasses.replace(self.loop.guards, headroom=float(v))

    @property
    def deadband(self) -> float:
        return self.loop.guards.deadband

    @deadband.setter
    def deadband(self, v: float) -> None:
        self.loop.guards = dataclasses.replace(self.loop.guards, deadband=float(v))

    @property
    def min_chips(self) -> int:
        return self.loop.policy.min_chips

    @min_chips.setter
    def min_chips(self, n: int) -> None:
        self.loop.policy.min_chips = n

    @property
    def max_chips(self) -> int:
        return self.loop.policy.max_chips

    @max_chips.setter
    def max_chips(self, n: int) -> None:
        self.loop.policy.max_chips = n

    def capacity_tokens_per_s(self, chips: int | None = None) -> float:
        return self.model.tokens_per_second(
            self.tokens_per_step, chips or self.chips
        )

    def observe(self, load_tokens_per_s: float) -> LMAllocation | None:
        """Returns a new allocation when a re-mesh is warranted, else None."""
        ev = self.loop.step(load_tokens_per_s)
        if not ev.acted:
            return None
        action = self.loop.action
        alloc: LMAllocation = action.detail
        chips = int(action.provisioned)
        if chips == self.chips:
            return None
        event = ElasticEvent(
            load_tokens_per_s, self.chips, chips, f"target={ev.target:.0f}tok/s"
        )
        self.chips = chips
        self.events.append(event)
        if self.on_remesh is not None:
            self.on_remesh(event)
        return alloc


class FleetElasticController:
    """Fleet-aware sibling of :class:`ElasticController`: the same
    observe-and-maybe-react idiom over N stream tenants sharing one finite
    cluster.

    ``observe`` feeds one load sample per tenant to a
    :class:`~repro_torch.fleet.FleetLoop` and returns the new
    :class:`~repro_torch.fleet.FleetPlan` when the fleet was rescheduled
    (any tenant's guards fired), else ``None``.  ``on_reschedule`` fires
    with the fleet event on every replan.  Reschedules are warm (the loop
    threads the deployed plan back into the scheduler), and the returned
    plan's ``total_moves`` / ``evictions`` count the churn a replan causes.
    ``evaluator`` is the loop's (e.g. a
    :class:`~repro_torch.streams.engine.SimulatorEvaluator` on the card);
    without one the loop plans and measures from the tenants' models.
    """

    def __init__(
        self,
        tenants: "Sequence[TenantSpec]",
        cluster: "Cluster",
        evaluator: "ConfigEvaluator | None" = None,
        saturation_threshold: float = 0.95,
        on_reschedule: "Callable[[FleetEvent], None] | None" = None,
    ) -> None:
        from ..fleet import FleetLoop

        self.loop = FleetLoop(
            tenants, cluster, evaluator,
            saturation_threshold=saturation_threshold,
        )
        self.on_reschedule = on_reschedule

    @property
    def events(self) -> "list[FleetEvent]":
        return self.loop.events

    @property
    def plan(self) -> "FleetPlan | None":
        return self.loop.plan

    @property
    def last_event(self) -> "FleetEvent | None":
        """The most recent fleet step event (moves/evictions included)."""
        return self.loop.events[-1] if self.loop.events else None

    def observe(self, loads: Mapping[str, float]) -> "FleetPlan | None":
        """Returns the new plan when the fleet was rescheduled, else None."""
        ev = self.loop.step(loads)
        if not ev.replanned:
            return None
        if self.on_reschedule is not None:
            self.on_reschedule(ev)
        return self.loop.plan
