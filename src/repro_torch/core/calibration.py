"""End-to-end model calibration, noise margins and drift detection (Trevor §4).

Two safeguards against the sampling-bias problem:

1. **Predict-back calibration**: use the trained models to predict the rate of
   configurations that were actually measured; the ratio predicted/measured
   becomes the internal *over-provisioning factor* the allocator applies
   (paper example: predict 1050 for a measured 965 → factor 1.09).
2. **Online pooling + drift detection**: as Trevor-generated (rate-matched)
   configurations deploy, their metrics push node instances into higher
   utilization ranges, improving the fit; when the rolling prediction error
   exceeds a threshold, declare model drift and trigger retraining.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Mapping

from .dag import Configuration
from .flow_solver import solve_flow
from .node_model import NodeModel


@dataclasses.dataclass
class CalibrationRecord:
    config_desc: str
    predicted_ktps: float
    measured_ktps: float

    @property
    def ratio(self) -> float:
        return self.predicted_ktps / max(self.measured_ktps, 1e-9)


class Calibrator:
    """Tracks predicted-vs-measured rates; owns the over-provisioning factor
    and the drift flag."""

    def __init__(
        self,
        drift_threshold: float = 0.25,
        window: int = 16,
        min_factor: float = 1.0,
        max_factor: float = 2.0,
    ) -> None:
        self.records: deque[CalibrationRecord] = deque(maxlen=window)
        self.drift_threshold = drift_threshold
        self.min_factor = min_factor
        self.max_factor = max_factor
        self._retrain_count = 0

    def observe(
        self,
        config: Configuration,
        models: Mapping[str, NodeModel],
        measured_ktps: float,
    ) -> CalibrationRecord:
        sol = solve_flow(config, models)
        rec = CalibrationRecord(config.describe(), sol.rate_ktps, measured_ktps)
        self.records.append(rec)
        return rec

    def observe_many(
        self,
        configs,
        models: Mapping[str, NodeModel],
        measured_ktps,
    ) -> list[CalibrationRecord]:
        """Record a batch of predicted-vs-measured pairs in one call — the
        natural sink for an engine's ``evaluate_batch`` output."""
        return [
            self.observe(c, models, float(m)) for c, m in zip(configs, measured_ktps)
        ]

    def observe_prediction(self, predicted_ktps: float, measured_ktps: float) -> None:
        self.records.append(CalibrationRecord("-", predicted_ktps, measured_ktps))

    @property
    def overprovision_factor(self) -> float:
        """Mean predicted/measured ratio, clamped to [min, max] (§4: 'we set
        the over-provisioning factor to 1.09')."""
        if not self.records:
            return self.min_factor
        mean_ratio = sum(r.ratio for r in self.records) / len(self.records)
        return min(self.max_factor, max(self.min_factor, mean_ratio))

    @property
    def mean_abs_error(self) -> float:
        if not self.records:
            return 0.0
        return sum(abs(r.ratio - 1.0) for r in self.records) / len(self.records)

    def drift_detected(self) -> bool:
        """True when the rolling relative error exceeds the threshold —
        the trigger for retraining that node's models."""
        if len(self.records) < 3:
            return False
        recent = list(self.records)[-3:]
        return all(abs(r.ratio - 1.0) > self.drift_threshold for r in recent)

    def mark_retrained(self) -> None:
        self._retrain_count += 1
        self.records.clear()

    @property
    def retrain_count(self) -> int:
        return self._retrain_count

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        """Mutable calibration state as numpy-compatible leaves (the
        configured thresholds/window are NOT serialized — they belong to
        the object the state is loaded back into)."""
        import numpy as np

        recs = list(self.records)
        return {
            "descs": np.asarray([r.config_desc for r in recs], dtype=str),
            "predicted": np.asarray(
                [r.predicted_ktps for r in recs], np.float64
            ),
            "measured": np.asarray(
                [r.measured_ktps for r in recs], np.float64
            ),
            "retrain_count": int(self._retrain_count),
        }

    def load_state_dict(self, state: dict) -> None:
        self.records.clear()
        for desc, p, m in zip(
            state["descs"], state["predicted"], state["measured"]
        ):
            self.records.append(
                CalibrationRecord(str(desc), float(p), float(m))
            )
        self._retrain_count = int(state["retrain_count"])
