"""Declarative auto-scaling agent (Trevor fig. 2b, §3) — back-compat shim.

The control logic lives in :mod:`repro_torch.control` now: :class:`AutoScaler` is
a thin wrapper over a :class:`~repro_torch.control.loop.ControlLoop` driving a
:class:`~repro_torch.control.policies.DeclarativePolicy`, with headroom/deadband
enforced by the shared :class:`~repro_torch.control.loop.GuardBands` and the
online loop (pool metrics, recalibrate, retrain on drift) owned by a
:class:`~repro_torch.control.learning.ModelStore`.  The public surface
(`configure_for`, `observe_load`, `observe_measurement(s)`,
`calibrate_with`, `retrain`, `events`, `run_against_trace`) is unchanged.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Callable, Mapping, Sequence

from .allocator import AllocationResult

if TYPE_CHECKING:
    from ..streams.engine import ConfigEvaluator
from .calibration import Calibrator
from .dag import Configuration, ContainerDim, DagSpec
from .metrics import MetricsStore
from .node_model import NodeModel


@dataclasses.dataclass
class ScalingEvent:
    t: float
    load_ktps: float
    target_ktps: float
    n_containers: int
    total_cpus: float
    reason: str
    alloc_seconds: float


class AutoScaler:
    """Model-based auto-scaler (thin shim over the unified control loop).

    Parameters
    ----------
    headroom: multiplicative spare capacity on top of the observed load
        (absorbs spikes between scaling decisions).
    deadband: relative load change that triggers reallocation; within the
        deadband the current configuration is kept (avoids flapping).
    """

    def __init__(
        self,
        dag: DagSpec,
        models: Mapping[str, NodeModel],
        headroom: float = 1.2,
        deadband: float = 0.15,
        preferred_dim: ContainerDim | None = None,
        calibrator: Calibrator | None = None,
        forecaster=None,
        horizon: int = 4,
    ) -> None:
        from ..control.learning import ModelStore
        from ..control.loop import ControlLoop, GuardBands
        from ..control.policies import DeclarativePolicy

        self.dag = dag
        self.store = ModelStore(models, calibrator)
        self.loop = ControlLoop(
            DeclarativePolicy(dag, self.store, preferred_dim=preferred_dim),
            guards=GuardBands(headroom=headroom, deadband=deadband),
            learner=self.store,
            # optional forecast phase: observe_load plans for the window peak
            forecaster=forecaster,
            horizon=horizon,
            auto_retrain=False,   # back-compat: the caller decides when to retrain
        )
        self.events: list[ScalingEvent] = []

    # -- tunables forwarded live to the loop/policy (not captured copies) ---
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
    def preferred_dim(self) -> ContainerDim | None:
        return self.loop.policy.preferred_dim

    @preferred_dim.setter
    def preferred_dim(self, dim: ContainerDim | None) -> None:
        self.loop.policy.preferred_dim = dim

    @property
    def models(self) -> dict[str, NodeModel]:
        return self.store.models

    @models.setter
    def models(self, models: Mapping[str, NodeModel]) -> None:
        if models is not self.store.models:
            self.store.models.clear()
            self.store.models.update(models)

    @property
    def calibrator(self) -> Calibrator:
        return self.store.calibrator

    @property
    def current(self) -> AllocationResult | None:
        return self.loop.action.detail if self.loop.action is not None else None

    def _record_event(self, ev, reason: str) -> None:
        """Map one acted ControlEvent to the legacy ScalingEvent shape."""
        self.events.append(
            ScalingEvent(
                t=time.time(),
                load_ktps=ev.load,
                target_ktps=ev.target,
                n_containers=ev.containers,
                total_cpus=ev.provisioned,
                reason=reason,
                alloc_seconds=ev.plan_seconds,
            )
        )

    # -- one-shot declarative interface (fig. 2b) --------------------------
    def configure_for(self, target_ktps: float, reason: str = "declared") -> AllocationResult:
        ev = self.loop.declare(target_ktps, reason=reason)
        res = self.current
        assert res is not None
        self._record_event(ev, reason)
        return res

    # -- load-following loop ------------------------------------------------
    def observe_load(self, load_ktps: float) -> AllocationResult | None:
        """Called with the current observed load; returns a new allocation
        when the guard bands allow replanning (else None = keep current)."""
        ev = self.loop.step(load_ktps)
        if not ev.acted:
            return None
        res = self.current
        assert res is not None
        self._record_event(ev, f"load={load_ktps:.0f}ktps")
        return res

    # -- online refinement (§4) ----------------------------------------------
    def observe_measurement(self, config: Configuration, measured_ktps: float) -> bool:
        """Record predicted-vs-measured; returns True if drift was declared
        (caller should retrain via :meth:`retrain`)."""
        return self.store.observe(config, measured_ktps)

    def observe_measurements(
        self, configs: Sequence[Configuration], measured_ktps: Sequence[float]
    ) -> bool:
        """Batch form of :meth:`observe_measurement` — e.g. one
        ``evaluate_batch`` worth of saturated capacity measurements."""
        return self.store.observe_many(configs, measured_ktps)

    def calibrate_with(
        self, evaluator: "ConfigEvaluator", configs: Sequence[Configuration]
    ) -> bool:
        """Measure ``configs`` at overload through any evaluation engine and
        feed the capacities into predict-back calibration (§4)."""
        evals = evaluator.evaluate_batch(configs)
        return self.observe_measurements(
            list(configs), [e.achieved_ktps for e in evals]
        )

    def retrain(self, store: MetricsStore) -> None:
        """Refit every node model from pooled metrics and reset calibration."""
        self.store.retrain(store)

    # -- reporting ------------------------------------------------------------
    @property
    def reconfigurations(self) -> int:
        return len(self.events)

    def mean_alloc_seconds(self) -> float:
        if not self.events:
            return 0.0
        return sum(e.alloc_seconds for e in self.events) / len(self.events)


def run_against_trace(
    scaler: AutoScaler,
    load_trace_ktps,
    measure: Callable[[Configuration, float], float] | None = None,
    evaluator: "ConfigEvaluator | None" = None,
    saturation_threshold: float = 0.98,
) -> list[tuple[float, float, float]]:
    """Drive the scaler with a load trace.  Returns per-step
    (load, provisioned_cpus, achieved_rate) tuples.  ``measure(config, load)``
    is typically the simulator; when given, measurements feed calibration.

    Passing an ``evaluator`` instead of a raw callback routes measurements
    through the engine layer: with the simulator backend's sticky shape
    buckets, every step of the trace runs at the same launch shape (a
    couple at most for a whole autoscaling run), and the saturated
    measurements reach the calibrator in batches through the
    ``observe_measurements`` API rather than one call per step.

    A measurement below ``saturation_threshold * load`` is treated as
    saturated: only those reveal true capacity (an unsaturated rate would
    miscalibrate the predictor, §4).
    """
    loop = scaler.loop
    prev = (loop.evaluator, loop.measure, loop.saturation_threshold)
    loop.evaluator = evaluator
    loop.measure = measure
    loop.saturation_threshold = saturation_threshold
    try:
        records = loop.run([float(x) for x in load_trace_ktps])
    finally:
        loop.evaluator, loop.measure, loop.saturation_threshold = prev
    for ev in loop.events[len(loop.events) - len(records):]:
        if ev.acted:
            scaler._record_event(ev, f"load={ev.load:.0f}ktps")
    return [(r.load, r.provisioned, r.achieved) for r in records]
