"""Unified control plane: one sense→forecast→plan→act→learn loop for every
scaling policy (declarative one-shot, Dhalion-style reactive, hybrid,
horizon-predictive, LM card planning), with shared guard bands (plus
scenario-conditioned presets), online load forecasting, a uniform event
log that records why each action fired, pooled learning/drift/retraining,
and a scenario-diverse load-trace library.  A host-side (numpy) copy of the
reference package's control plane; the policies score configurations
through :class:`~repro_torch.streams.engine.SimulatorEvaluator` on the
card, and :func:`fold_executor_timings` folds the real executor's timings
into the simulator's physics."""

from .loop import (
    Action,
    ControlContext,
    ControlEvent,
    ControlLoop,
    GuardBands,
    LoadSource,
    PlanContext,
    Policy,
    StepRecord,
)
from .forecast import (
    FORECASTERS,
    Forecaster,
    HoltWintersForecaster,
    LastValueForecaster,
    ReplayForecaster,
    make_forecaster,
)
from .learning import ForecastTracker, ModelStore, fold_executor_timings
from .policies import (
    DeclarativePolicy,
    ElasticLMPolicy,
    HybridPolicy,
    PredictivePolicy,
    ReactivePolicy,
)
from .scenarios import (
    FAILURE_SCENARIOS,
    GUARD_PRESETS,
    SCENARIOS,
    make_failure_trace,
    make_trace,
    replay,
)

__all__ = [
    "Action", "ControlContext", "ControlEvent", "ControlLoop",
    "DeclarativePolicy", "ElasticLMPolicy", "FAILURE_SCENARIOS",
    "FORECASTERS", "ForecastTracker",
    "Forecaster", "GUARD_PRESETS", "GuardBands", "HoltWintersForecaster",
    "HybridPolicy", "LastValueForecaster", "LoadSource", "ModelStore",
    "PlanContext", "Policy", "PredictivePolicy", "ReactivePolicy",
    "ReplayForecaster", "SCENARIOS", "StepRecord", "fold_executor_timings",
    "make_failure_trace", "make_forecaster", "make_trace", "replay",
]
