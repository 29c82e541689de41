"""Unified control plane: one sense→forecast→plan→act→learn loop.

Trevor's core claim (§3–§4) is that one learned performance model can drive
*all* control decisions — one-shot configuration, load-following
auto-scaling, and online refinement under drift.  :class:`ControlLoop` is
the one driver every scaling policy shares, with one semantics for the
headroom/deadband guards and the measurement feedback:

* **sense** — pull the next load sample from any iterable
  (:data:`LoadSource`); derive the provisioning target through the shared
  :class:`GuardBands` headroom,
* **forecast** — when a :class:`~repro_torch.control.forecast.Forecaster` is
  plugged in, project the load over the next ``horizon`` steps; the guards
  then judge the *window peak* rather than the instantaneous target, so
  capacity is acquired ahead of a predicted breach and released only when
  the whole window allows it.  The deployed action's predicted capacity and
  the last measurement still spot an SLA breach (the reactive safety net),
* **plan** — ask the plugged-in :class:`Policy` for a new
  :class:`Action` when (and only when) the guards allow it — deadband holds
  and anti-thrash hysteresis are enforced *here*, identically for every
  policy.  The policy sees the forecast window through
  :class:`PlanContext`; policies that ignore it plan a degenerate
  horizon-1 exactly as before,
* **act** — "deploy" the planned configuration and measure it through any
  :class:`~repro_torch.streams.engine.ConfigEvaluator` backend (or a raw
  ``measure`` callback),
* **learn** — feed saturated measurements to the :class:`ModelStore` in
  batches (predict-back calibration, §4), pool trajectory metrics, retrain
  the node models when drift is declared, and score every one-step-ahead
  forecast against the sensed load
  (:class:`~repro_torch.control.learning.ForecastTracker` — persistent forecast
  bias becomes an online multiplicative correction).

Every step emits one uniform :class:`ControlEvent` which records both the
guard outcome *and* the cause of the action — a proactive forecast step is
distinguishable from a reactive guard step and from a measured-SLA
override, row-for-row across policies.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Callable, Iterable, Protocol, runtime_checkable

import numpy as np

from ..core.dag import Configuration

if TYPE_CHECKING:
    from ..streams.engine import ConfigEvaluator
    from .forecast import Forecaster
    from .learning import ModelStore

#: Anything that yields load samples (ktps for stream policies, tokens/s for
#: LM policies): a list, a numpy array, a generator over live telemetry...
LoadSource = Iterable[float]


@dataclasses.dataclass(frozen=True)
class GuardBands:
    """Shared scaling guards: headroom, deadband, anti-thrash hysteresis.

    Every policy gets one semantics from this one place:

    * the provisioning target is ``load * headroom``,
    * a relative target change below ``deadband`` holds (no flapping),
    * scale-*down* additionally requires the target to clear a wider
      hysteresis band (``down_hysteresis`` deadbands below the reference) —
      capacity is released reluctantly, acquired eagerly,
    * a measured SLA breach overrides both holds.
    """

    headroom: float = 1.2
    deadband: float = 0.15
    down_hysteresis: float = 2.0   # scale-down band, in multiples of deadband

    @classmethod
    def for_scenario(cls, name: str) -> "GuardBands":
        """Scenario-conditioned preset: guard bands tuned to a named traffic
        shape from :data:`repro_torch.control.scenarios.SCENARIOS` (tight deadband
        for ``step``'s clean level shifts, wide hysteresis for
        ``bursty``/``flash_crowd`` transients, ...).  Raises ``KeyError``
        for names without a preset."""
        from .scenarios import GUARD_PRESETS

        if name not in GUARD_PRESETS:
            raise KeyError(
                f"no guard-band preset for scenario {name!r}; "
                f"available: {sorted(GUARD_PRESETS)}"
            )
        return cls(**GUARD_PRESETS[name])

    def target_for(self, load: float) -> float:
        """The provisioning target for a sensed ``load``: capacity to plan
        for, i.e. ``load * headroom``."""
        return load * self.headroom

    def decide(
        self, target: float, reference: float, breached: bool = False
    ) -> tuple[bool, str]:
        """Should the loop replan for ``target``, given the last planned
        ``reference`` target?  Returns ``(act?, reason)``; ``breached`` is
        the measured-shortfall override."""
        if reference <= 0:
            return True, "bootstrap"
        if breached:
            return True, "breach"
        rel = abs(target - reference) / reference
        if rel < self.deadband:
            return False, "deadband"
        if target < reference:
            if target > reference / (1.0 + self.down_hysteresis * self.deadband):
                return False, "anti-thrash"
            return True, "scale-down"
        return True, "scale-up"


@dataclasses.dataclass
class Action:
    """What a policy decided to deploy."""

    provisioned: float                  # capacity units: CPUs (stream) / chips (LM)
    predicted_capacity: float           # sustainable rate the policy expects
    config: Configuration | None = None  # stream configuration (None for LM policies)
    detail: object = None               # AllocationResult / LMAllocation / policy dict
    reason: str = ""
    # the policy's own capacity probe of ``config`` taken while planning (an
    # EvalResult from candidate scoring); the loop then derives the delivered
    # rate — and pools the probe's metrics — instead of re-measuring
    measurement: object = None


@dataclasses.dataclass
class ControlContext:
    """What a policy may consult while planning.

    ``horizon`` / ``horizon_targets`` carry the forecast window (the
    expected loads over the next H steps and their headroom-adjusted
    provisioning targets).  Without a forecaster both are ``None`` and a
    policy plans the degenerate horizon-1 — exactly the pre-forecast
    contract.  Predictive policies pick the cheapest configuration
    feasible for the *whole* window.
    """

    load: float
    target: float
    evaluator: "ConfigEvaluator | None"
    action: Action | None               # currently deployed action, if any
    achieved: float | None              # last measurement of the deployed action
    bottleneck: str | None
    horizon: np.ndarray | None = None          # forecast loads, shape (H,)
    horizon_targets: np.ndarray | None = None  # guards.target_for(forecast)

    def window_loads(self) -> np.ndarray:
        """Current load followed by the forecast window (degenerate: just
        the current load) — the rates a horizon plan must survive."""
        if self.horizon is None or len(self.horizon) == 0:
            return np.array([self.load])
        return np.concatenate([[self.load], np.asarray(self.horizon, float)])

    def window_targets(self) -> np.ndarray:
        """Current target followed by the forecast-window targets."""
        if self.horizon_targets is None or len(self.horizon_targets) == 0:
            return np.array([self.target])
        return np.concatenate(
            [[self.target], np.asarray(self.horizon_targets, float)]
        )


#: A policy's view of one planning request — the public name of the
#: context since the plan contract grew the forecast horizon.
PlanContext = ControlContext


@runtime_checkable
class Policy(Protocol):
    """A scaling brain: maps a provisioning target to an :class:`Action`.

    Policies own *what* to deploy; the loop owns *when* (guards), *how it is
    scored* (evaluator) and *what is learned* (calibration, drift, retrain).
    """

    name: str

    def plan(self, target: float, ctx: ControlContext) -> Action: ...


@dataclasses.dataclass
class ControlEvent:
    """One uniform log row per control step, identical across policies.

    ``guard`` is the band decision (bootstrap / breach / forecast /
    scale-up / scale-down / deadband / anti-thrash / declared); ``cause``
    records *why* an action fired — ``"guard"`` (reactive threshold),
    ``"forecast"`` (proactive: the window peak demanded capacity the
    instantaneous target did not), ``"measured-sla"`` (a measured breach
    overrode the holds), ``"predicted-shortfall"`` (capacity-model policies
    whose own prediction missed the target), ``"bootstrap"`` /
    ``"declared"``, or ``""`` when the step held.
    """

    step: int
    load: float
    target: float
    acted: bool
    guard: str                 # bootstrap / breach / forecast / scale-up / scale-down / deadband / anti-thrash / declared
    policy: str
    provisioned: float
    predicted_capacity: float
    containers: int = 0        # containers (stream) / chips (LM) deployed
    achieved: float = float("nan")
    bottleneck: str | None = None
    drift: bool = False
    retrained: bool = False
    plan_seconds: float = 0.0
    cause: str = ""            # why the action fired (empty on held steps)
    forecast_peak: float = float("nan")  # peak of the forecast window (loads)


@dataclasses.dataclass
class StepRecord:
    """Per-step trace record — the tuple ``run_against_trace`` always returned."""

    load: float
    provisioned: float
    achieved: float


class ControlLoop:
    """The sense→predict→plan→act→learn driver, generic over policies.

    Parameters
    ----------
    policy: the scaling brain (declarative, reactive, hybrid, predictive...).
    guards: shared :class:`GuardBands`; identical semantics for every policy.
    evaluator: any :class:`~repro_torch.streams.engine.ConfigEvaluator` used to
        measure deployed configurations (the act phase).  Saturated simulator
        runs additionally pool their trajectory metrics into the learner —
        the raw material for drift retraining.
    measure: raw ``(config, load) -> achieved`` (or ``(achieved, bottleneck)``)
        callback, used when no evaluator is given.
    learner: a :class:`~repro_torch.control.learning.ModelStore` receiving
        saturated measurements (batched through ``observe_many``) and, on
        drift, retraining node models from its pooled metrics.
    forecaster: a :class:`~repro_torch.control.forecast.Forecaster` observing the
        sensed load and projecting the next ``horizon`` steps.  The guards
        then judge the window *peak* target (scale up ahead of a predicted
        rise, defer scale-down while the window still needs the capacity),
        and policies receive the window through :class:`PlanContext`.
        One-step-ahead forecasts are scored against the sensed load by a
        :class:`~repro_torch.control.learning.ForecastTracker`, whose clipped
        bias correction multiplies future windows.
    horizon: forecast window length in steps (only used with a forecaster).
    saturation_threshold: a measurement below ``threshold * load`` means the
        deployment could not keep up — it reveals true capacity (feeds
        calibration) and flags an SLA breach for the guards.
    calibration_batch: measurements are buffered and flushed to the learner
        in batches of this size (plus a final flush in :meth:`run`).
    """

    def __init__(
        self,
        policy: Policy,
        guards: GuardBands = GuardBands(),
        evaluator: "ConfigEvaluator | None" = None,
        measure: Callable | None = None,
        learner: "ModelStore | None" = None,
        forecaster: "Forecaster | None" = None,
        horizon: int = 4,
        saturation_threshold: float = 0.98,
        calibration_batch: int = 8,
        auto_retrain: bool = True,
    ) -> None:
        from .learning import ForecastTracker

        self.policy = policy
        self.guards = guards
        self.evaluator = evaluator
        self.measure = measure
        self.learner = learner
        # a result-caching evaluator keys entries on its version_source's
        # ``version``: wire the learner in when the caller left it unset,
        # so every observe/retrain invalidates cached evaluations (the
        # models the cache was filled under no longer exist)
        if (
            learner is not None
            and evaluator is not None
            and getattr(evaluator, "version_source", False) is None
        ):
            evaluator.version_source = learner
        self.forecaster = forecaster
        self.horizon = max(1, int(horizon))
        self.forecast_tracker = (
            ForecastTracker() if forecaster is not None else None
        )
        self.saturation_threshold = saturation_threshold
        self.calibration_batch = max(1, int(calibration_batch))
        self.auto_retrain = auto_retrain
        self.action: Action | None = None
        self.events: list[ControlEvent] = []
        self.records: list[StepRecord] = []
        self._last_target = 0.0
        self._last_achieved: float | None = None
        self._last_bottleneck: str | None = None
        self._last_forecast: np.ndarray | None = None
        self._breached = False
        self._pending_configs: list[Configuration] = []
        self._pending_measured: list[float] = []

    # -- load-following interface -------------------------------------------
    def step(self, load: float) -> ControlEvent:
        """One sense→forecast→plan→act→learn iteration for one load sample."""
        load = float(load)
        target = self.guards.target_for(load)                       # sense
        horizon = horizon_targets = None
        plan_target = target
        if self.forecaster is not None:                             # forecast
            # learn phase for the forecaster: score the previous step's
            # one-step-ahead prediction against the load that arrived
            # (ForecastTracker defines __len__, so test identity, not truth)
            if self._last_forecast is not None and self.forecast_tracker is not None:
                self.forecast_tracker.observe(
                    float(self._last_forecast[0]), load
                )
            self.forecaster.observe(load)
            raw = np.asarray(self.forecaster.forecast(self.horizon), float)
            self._last_forecast = raw
            correction = (
                self.forecast_tracker.factor()
                if self.forecast_tracker is not None
                else 1.0
            )
            horizon = raw * correction
            horizon_targets = np.array(
                [self.guards.target_for(x) for x in horizon]
            )
            if horizon_targets.size:
                plan_target = max(target, float(horizon_targets.max()))
        # _breached was set when the deployment was last measured — it could
        # not keep up with the load offered to it.  Capacity-model
        # deployments (no measurement channel, config is None) have no such
        # signal; there the model itself is the sensor, and a predicted
        # shortfall against the *new* target is actionable immediately.
        breached = self._breached
        predicted_shortfall = False
        if not breached and self.action is not None and self.action.config is None:
            breached = predicted_shortfall = (
                self.action.predicted_capacity < plan_target
            )
        # the guards judge the window peak: capacity is acquired ahead of a
        # forecast rise, and released only when the whole window allows it
        act, guard = self.guards.decide(plan_target, self._last_target, breached)
        cause = ""
        if act:
            if guard == "breach":
                cause = "predicted-shortfall" if predicted_shortfall else "measured-sla"
            elif self.forecaster is not None:
                # proactive iff the instantaneous target alone would NOT
                # have produced this same decision — it would have held, or
                # acted in the other direction (e.g. sensed says release,
                # the window peak says acquire)
                act_now, guard_now = self.guards.decide(
                    target, self._last_target, False
                )
                if act_now and guard_now == guard:
                    cause = "guard"
                else:
                    guard = cause = "forecast"
            else:
                cause = "guard"
        if self.action is None:
            act, guard, cause = True, "bootstrap", "bootstrap"
        return self._execute(
            load, target, act, guard,
            cause=cause, plan_target=plan_target,
            horizon=horizon, horizon_targets=horizon_targets,
        )

    def run(self, loads: LoadSource) -> list[StepRecord]:
        """Drive the loop over a whole load trace; returns per-step records.
        Buffered calibration measurements are flushed at the end."""
        start = len(self.records)
        for load in loads:
            self.step(load)
        drift = self.flush_calibration()
        if drift and self.auto_retrain and self.learner is not None:
            self.learner.retrain()
        return self.records[start:]

    # -- one-shot declarative interface (fig. 2b) ---------------------------
    def declare(self, target: float, reason: str = "declared") -> ControlEvent:
        """Plan for ``target`` unconditionally, bypassing sensing and guards
        — the paper's declarative workflow (operator states the rate)."""
        return self._execute(target, float(target), True, reason, cause="declared")

    # -- internals ----------------------------------------------------------
    def _execute(
        self,
        load: float,
        target: float,
        act: bool,
        guard: str,
        cause: str = "",
        plan_target: float | None = None,
        horizon: np.ndarray | None = None,
        horizon_targets: np.ndarray | None = None,
    ) -> ControlEvent:
        plan_target = target if plan_target is None else plan_target
        plan_s = 0.0
        if act:                                                     # plan
            ctx = ControlContext(
                load=load,
                target=plan_target,
                evaluator=self.evaluator,
                action=self.action,
                achieved=self._last_achieved,
                bottleneck=self._last_bottleneck,
                horizon=horizon,
                horizon_targets=horizon_targets,
            )
            t0 = time.perf_counter()
            self.action = self.policy.plan(plan_target, ctx)
            plan_s = time.perf_counter() - t0
            self._last_target = plan_target
            # the breach verdict belonged to the replaced deployment; it
            # re-arms only from a fresh measurement of the new one
            self._breached = False
        assert self.action is not None, "policy returned no action"

        achieved = float("nan")                                     # act
        drift = retrained = False
        probe = self.action.measurement
        if act and probe is not None:
            # the policy already measured this configuration's capacity while
            # planning (reactive/hybrid candidate scoring): deriving the
            # delivered rate saves a second deploy+measure cycle per step
            achieved = min(probe.achieved_ktps, load)
            self._last_bottleneck = probe.bottleneck
            self._last_achieved = achieved
            self._breached = achieved < self.saturation_threshold * load
            if self.action.config is not None:
                drift, retrained = self._learn(
                    self.action.config, load, achieved, getattr(probe, "sim", None)
                )
        elif self.action.config is not None:
            m = self._measure(self.action.config, load)
            if m is not None:
                achieved, self._last_bottleneck, sim = m
                self._last_achieved = achieved
                self._breached = achieved < self.saturation_threshold * load
                drift, retrained = self._learn(
                    self.action.config, load, achieved, sim
                )
        else:
            # capacity-model policies (LM): the model is the only sensor; the
            # predicted-shortfall check happens at sense time in step()
            self._last_achieved = self.action.predicted_capacity

        ev = ControlEvent(
            step=len(self.events),
            load=load,
            target=target,
            acted=act,
            guard=guard,
            policy=self.policy.name,
            provisioned=self.action.provisioned,
            predicted_capacity=self.action.predicted_capacity,
            containers=(
                self.action.config.n_containers
                if self.action.config is not None
                else int(self.action.provisioned)
            ),
            achieved=achieved,
            bottleneck=self._last_bottleneck,
            drift=drift,
            retrained=retrained,
            plan_seconds=plan_s,
            cause=cause if act else "",
            forecast_peak=(
                float(np.max(horizon))
                if horizon is not None and len(horizon)
                else float("nan")
            ),
        )
        self.events.append(ev)
        self.records.append(StepRecord(load, self.action.provisioned, achieved))
        return ev

    def _measure(
        self, config: Configuration, load: float
    ) -> tuple[float, str | None, object] | None:
        if self.measure is not None:
            m = self.measure(config, load)
            if isinstance(m, tuple):
                return float(m[0]), m[1], None
            return float(m), None, None
        if self.evaluator is not None:
            # summary-mode evaluators (the SimulatorEvaluator default) hand
            # back a lazily-backed SimResult here: the achieved/bottleneck
            # reads below cost no trajectory transfer, and _learn's
            # ``sim.to_metrics_store()`` — reached only on the rare
            # saturated steps that feed the retrain pool — transparently
            # refetches the full trajectory for exactly those rows
            r = self.evaluator.evaluate(config, offered_ktps=load)
            return r.achieved_ktps, r.bottleneck, r.sim
        return None

    def _learn(
        self, config: Configuration, load: float, achieved: float, sim=None
    ) -> tuple[bool, bool]:
        if self.learner is None:
            return False, False
        drift = retrained = False
        if achieved < self.saturation_threshold * load:
            # Only a saturated measurement reveals true capacity; feeding an
            # unsaturated rate would miscalibrate the predictor (§4).  The
            # same runs donate their metric trajectories to the retrain pool:
            # they describe the world as it is *now* (post-drift), at the
            # high-utilization operating points that sharpen the fits.
            self._pending_configs.append(config)
            self._pending_measured.append(achieved)
            if sim is not None:
                self.learner.pool(sim.to_metrics_store())
        if len(self._pending_configs) >= self.calibration_batch:
            drift = self.flush_calibration()
        if drift and self.auto_retrain:
            retrained = self.learner.retrain() is not None
        return drift, retrained

    def flush_calibration(self) -> bool:
        """Push buffered measurements to the learner through the batch API
        (``observe_many``); returns the learner's drift verdict."""
        if self.learner is None:
            return False
        if self._pending_configs:
            drift = self.learner.observe_many(
                self._pending_configs, self._pending_measured
            )
            self._pending_configs = []
            self._pending_measured = []
            return drift
        return self.learner.drift_detected()
