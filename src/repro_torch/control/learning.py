"""Unified learning layer of the control plane (Trevor §4).

Calibration, drift detection and retraining have one owner,
:class:`ModelStore`: it pools measurements from *any* evaluation engine,
exposes the over-provisioning factor to every policy, and — on drift —
refits the node models from the pooled Heron-style metrics.

:func:`fold_executor_timings` closes the loop between the two evaluation
backends: operator timings measured by the real executor are folded back
into the simulator's physical truth (calibrated per-node costs + a
speed-scaled stream-manager cost in :class:`SimParams`), so drift
experiments can replay "the same pipeline, on this machine" through the
batched simulator.

:class:`ForecastTracker` extends the same predict-back idiom to the
forecast phase: one-step-ahead forecasts are scored against the sensed
load, and a persistent bias becomes a multiplicative correction factor on
future forecast windows — online refinement for the forecaster, exactly
as the calibrator's over-provisioning factor refines the node models.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Mapping, Sequence

import numpy as np

from ..core.calibration import Calibrator
from ..core.dag import Configuration, DagSpec
from ..core.metrics import MetricsStore
from ..core.node_model import LinearFit, NodeModel, ResourceClass, fit_workload

if TYPE_CHECKING:
    from ..streams.engine import ExecutorEvaluator
    from ..streams.simulator import SimParams


class ModelStore:
    """Pools measurements, owns the node models and the calibration state.

    Every policy reads ``models`` and ``overprovision_factor`` from here;
    every evaluator's measurements come back through ``observe`` /
    ``observe_many`` (predict-back calibration) and ``pool`` (raw metric
    timeseries for retraining).  When the calibrator declares drift,
    :meth:`retrain` refits every node model from the pooled metrics — the
    paper's "keep pooling metrics and improve model performance" loop.
    """

    def __init__(
        self,
        models: Mapping[str, NodeModel],
        calibrator: Calibrator | None = None,
        max_pooled_samples: int = 4096,
    ) -> None:
        self.models = dict(models)
        self.calibrator = calibrator or Calibrator()
        self.metrics = MetricsStore()
        self.max_pooled_samples = max_pooled_samples
        #: monotonic mutation counter: bumped whenever calibration state or
        #: the node models change, so downstream memos (the engine layer's
        #: evaluation ResultCache via ``version_source``) can key on it
        #: instead of hashing model contents every replan — a bump makes
        #: every result computed under the old models unreachable
        self.version = 0

    # -- calibration (predict-back, §4) -------------------------------------
    @property
    def overprovision_factor(self) -> float:
        return self.calibrator.overprovision_factor

    def observe(self, config: Configuration, measured_ktps: float) -> bool:
        """Record one predicted-vs-measured pair; returns the drift flag."""
        self.calibrator.observe(config, self.models, measured_ktps)
        self.version += 1
        return self.drift_detected()

    def observe_many(
        self, configs: Sequence[Configuration], measured_ktps: Sequence[float]
    ) -> bool:
        """Batch form — the natural sink for ``evaluate_batch`` output and
        for the control loop's buffered saturated measurements."""
        self.calibrator.observe_many(configs, self.models, measured_ktps)
        self.version += 1
        return self.drift_detected()

    def drift_detected(self) -> bool:
        return self.calibrator.drift_detected()

    @property
    def retrain_count(self) -> int:
        return self.calibrator.retrain_count

    # -- metric pooling + retraining ----------------------------------------
    def pool(self, store: MetricsStore) -> None:
        """Accumulate Heron-style metric timeseries (bounded: oldest samples
        are dropped once ``max_pooled_samples`` instance-series are held)."""
        self.metrics.extend(store)
        excess = len(self.metrics) - self.max_pooled_samples
        if excess > 0:
            self.metrics.samples = self.metrics.samples[excess:]

    def retrain(self, store: MetricsStore | None = None) -> dict[str, NodeModel] | None:
        """Refit every node model from ``store`` (default: the pooled
        metrics) and reset the calibration window.  Returns the refit models,
        or None when there is nothing to fit from."""
        src = store if store is not None else self.metrics
        if len(src) == 0:
            return None
        fitted = fit_workload(src)
        self.models.update(fitted)
        self.calibrator.mark_retrained()
        self.version += 1
        return fitted

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        """Everything a restarted controller needs to resume *warm*, as a
        nested dict of numpy-compatible leaves: the node models (exact
        float64 fit parameters), the calibration records behind the
        over-provisioning factor, and the monotonic ``version`` counter —
        the token every downstream memo (candidate ladders, the engine's
        ResultCache) keys on, so cached results stay exactly as (in)valid
        after a restart as before it.  Pooled raw metrics are NOT
        serialized: they are a bounded re-fillable buffer, not control
        state."""
        models: dict = {}
        for name, m in self.models.items():
            if "/" in name:
                raise ValueError(
                    f"node name {name!r} contains '/', which the checkpoint "
                    "tree layout reserves as its key separator"
                )
            models[name] = {
                "cpu": np.asarray(
                    [m.cpu.slope, m.cpu.intercept, m.cpu.r2,
                     m.cpu.x_min, m.cpu.x_max], np.float64
                ),
                "cap": np.asarray(
                    [m.cap.slope, m.cap.intercept, m.cap.r2,
                     m.cap.x_min, m.cap.x_max], np.float64
                ),
                "scalars": np.asarray(
                    [m.gamma, m.gamma_r2, m.mem_base_mb,
                     m.mem_slope_mb_per_ktps], np.float64
                ),
                "resource_class": str(m.resource_class.value),
                "n_samples": int(m.n_samples),
            }
        return {
            "version": int(self.version),
            "models": models,
            "calibrator": self.calibrator.state_dict(),
        }

    def load_state_dict(self, state: dict) -> None:
        """Inverse of :meth:`state_dict` — restores the node models, the
        calibration window and the version counter bit-for-bit (the
        restored store predicts, provisions and cache-keys exactly like
        the one that was saved)."""
        models: dict[str, NodeModel] = {}
        for name, s in state["models"].items():
            cpu = np.asarray(s["cpu"], np.float64)
            cap = np.asarray(s["cap"], np.float64)
            scalars = np.asarray(s["scalars"], np.float64)
            models[name] = NodeModel(
                name=name,
                cpu=LinearFit(*(float(x) for x in cpu)),
                cap=LinearFit(*(float(x) for x in cap)),
                gamma=float(scalars[0]),
                gamma_r2=float(scalars[1]),
                mem_base_mb=float(scalars[2]),
                mem_slope_mb_per_ktps=float(scalars[3]),
                resource_class=ResourceClass(str(s["resource_class"])),
                n_samples=int(s["n_samples"]),
            )
        self.models = models
        self.calibrator.load_state_dict(state["calibrator"])
        self.version = int(state["version"])


class ForecastTracker:
    """Predict-back calibration for forecasters (the §4 idiom, applied to
    the forecast phase).

    The control loop records each step's one-step-ahead forecast and, one
    step later, the load that actually arrived.  Over a sliding window the
    tracker exposes the forecast accuracy (:meth:`mean_abs_pct_error`) and
    a clipped multiplicative correction (:meth:`factor`): a forecaster that
    persistently under-predicts by 10% gets its windows scaled up by ~1.1
    before planning — the forecaster analogue of the calibrator's
    over-provisioning factor, learned online and never trusted beyond
    ``max_correction``.
    """

    def __init__(self, window: int = 32, max_correction: float = 1.5) -> None:
        if int(window) < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self.max_correction = float(max_correction)
        self.predicted: list[float] = []
        self.actual: list[float] = []

    def __len__(self) -> int:
        return len(self.actual)

    def observe(self, predicted: float, actual: float) -> None:
        """Record one (one-step-ahead forecast, sensed load) pair."""
        self.predicted.append(float(predicted))
        self.actual.append(float(actual))
        bound = 4 * self.window
        if len(self.actual) > bound:
            del self.predicted[:-bound]
            del self.actual[:-bound]

    def _recent(self) -> tuple[np.ndarray, np.ndarray]:
        p = np.asarray(self.predicted[-self.window :], np.float64)
        a = np.asarray(self.actual[-self.window :], np.float64)
        return p, a

    def mean_abs_pct_error(self) -> float:
        """Mean |actual - predicted| / actual over the window (NaN-free:
        zero-load steps are excluded)."""
        p, a = self._recent()
        mask = a > 1e-9
        if not mask.any():
            return 0.0
        return float(np.mean(np.abs(a[mask] - p[mask]) / a[mask]))

    def bias(self) -> float:
        """Signed mean (actual - predicted) / actual: positive = the
        forecaster under-predicts (the dangerous direction)."""
        p, a = self._recent()
        mask = a > 1e-9
        if not mask.any():
            return 0.0
        return float(np.mean((a[mask] - p[mask]) / a[mask]))

    def factor(self) -> float:
        """Multiplicative window correction: mean actual/predicted ratio
        over the window, clipped to [1/max_correction, max_correction]."""
        p, a = self._recent()
        mask = p > 1e-9
        if not mask.any():
            return 1.0
        ratio = float(np.mean(a[mask] / p[mask]))
        return float(
            np.clip(ratio, 1.0 / self.max_correction, self.max_correction)
        )


def fold_executor_timings(
    dag: DagSpec,
    evaluator: "ExecutorEvaluator | None" = None,
    params: "SimParams | None" = None,
    n_batches: int = 5,
    floor_ktps: float = 50.0,
    device=None,
) -> tuple[DagSpec, "SimParams"]:
    """Fold real-executor operator timings into the simulator's physics.

    Returns ``(calibrated_dag, calibrated_params)``: the DAG's ground-truth
    per-ktuple costs become the wall-clock costs measured by the executor,
    and ``SimParams.sm_cost_per_ktuple`` is rescaled by the median speed
    ratio (measured/spec cost over the timed operators) so the simulated
    stream managers slow down (or speed up) with the node bodies.  Feeding
    the result to a :class:`~repro_torch.streams.engine.SimulatorEvaluator`
    yields a simulator that drifts exactly as the measured machine drifts.

    The timings come from ``evaluator`` (its cached calibration, on its
    device) or, without one, from a fresh ``calibrate_dag`` run on
    ``device`` (``None``: the CUDA card).
    """
    from ..streams.simulator import SimParams
    import dataclasses

    if params is None:
        params = SimParams()
    if evaluator is not None:
        cal = evaluator.calibrated_dag(dag)
    else:
        from ..streams.executor import calibrate_dag

        cal = calibrate_dag(dag, n_batches=n_batches, floor_ktps=floor_ktps, device=device)
    ratios = [
        b.cpu_cost_per_ktuple / a.cpu_cost_per_ktuple
        for a, b in zip(dag.nodes, cal.nodes)
        if a.cpu_cost_per_ktuple > 0 and b.cpu_cost_per_ktuple != a.cpu_cost_per_ktuple
    ]
    scale = float(np.median(ratios)) if ratios else 1.0
    new_params = dataclasses.replace(
        params, sm_cost_per_ktuple=params.sm_cost_per_ktuple * scale
    )
    return cal, new_params
