"""Load forecasting: the **forecast** phase of sense→forecast→plan→act→learn.

Trevor's learned performance models answer "what does a deployment achieve
at rate R?" in closed form — but every policy so far asked that question
about the rate that *already arrived*.  Phoebe's lesson (PAPERS.md) is that
a QoS-aware scaler should anticipate dynamic workloads and provision ahead
of the breach; Daedalus ties the same anticipation to resource efficiency.
A :class:`Forecaster` supplies the missing input: a window of expected
future loads (the forecast *horizon*) derived online from the sensed
history, so policies can plan for what is COMING rather than what just
happened.

Three families, from weakest to strongest prior:

* :class:`LastValueForecaster` — flat last-value / EWMA baseline: the
  degenerate horizon-1 assumption every reactive policy makes implicitly,
* :class:`HoltWintersForecaster` — online level + trend + optional
  additive seasonality (Holt-Winters), the right shape for the paper's
  diurnal/weekly traffic curves,
* :class:`ReplayForecaster` — seasonal-naive history replay ("the next
  hour looks like this hour yesterday"), the strongest cheap baseline for
  strongly periodic load.

All forecasters are *online*: feed one sample at a time through
``observe`` and ask for a window with ``forecast(h)`` at any point.  A
forecast is never negative.  Forecast-error tracking and online bias
correction live in :class:`repro_torch.control.learning.ForecastTracker` — the
same predict-back-calibration idiom the node models get from
:class:`~repro_torch.control.learning.ModelStore`.

Every forecaster also exposes ``state_dict()`` / ``load_state_dict()`` —
plain dicts of numpy-compatible leaves that round-trip *bit for bit*, so a
restarted controller resumes with exactly the forecast state it crashed
with (no cold-start window, no re-learned seasonality)."""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class Forecaster(Protocol):
    """An online load forecaster: observe samples, emit a horizon window."""

    name: str

    def observe(self, load: float) -> None: ...

    def forecast(self, horizon: int) -> np.ndarray: ...


def _window(horizon: int) -> int:
    h = int(horizon)
    if h < 1:
        raise ValueError(f"forecast horizon must be >= 1, got {horizon}")
    return h


class LastValueForecaster:
    """Flat forecast: an EWMA of the history (``alpha=1`` = pure last value).

    The forecast window is constant at the current level — exactly the
    implicit assumption of every reactive policy, made explicit so it can
    be compared (and beaten) on equal terms.
    """

    def __init__(self, alpha: float = 1.0) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.level: float | None = None
        self.name = "last-value" if alpha == 1.0 else f"ewma({alpha:g})"

    def observe(self, load: float) -> None:
        x = float(load)
        if self.level is None:
            self.level = x
        else:
            self.level = self.alpha * x + (1.0 - self.alpha) * self.level

    def forecast(self, horizon: int) -> np.ndarray:
        h = _window(horizon)
        level = 0.0 if self.level is None else max(self.level, 0.0)
        return np.full(h, level)

    def state_dict(self) -> dict:
        # "no level yet" is a distinct state from "level 0.0": a flag leaf
        # keeps the None round-trip exact
        return {
            "has_level": 1 if self.level is not None else 0,
            "level": 0.0 if self.level is None else float(self.level),
        }

    def load_state_dict(self, state: dict) -> None:
        self.level = (
            float(state["level"]) if int(state["has_level"]) else None
        )


class HoltWintersForecaster:
    """Online Holt-Winters: level + trend (+ additive seasonality).

    With ``season >= 2`` the forecaster carries one additive seasonal
    component per phase of the period — the diurnal/weekly shape.  Without
    a season it degrades to Holt's linear-trend smoothing (still ahead of
    last-value on ramps).  All three components update in O(1) per sample;
    seasonal slots start at zero, so the forecaster is usable from the
    first observation and sharpens as the history covers full periods.
    """

    def __init__(
        self,
        season: int | None = None,
        alpha: float = 0.5,
        beta: float = 0.2,
        gamma: float = 0.3,
    ) -> None:
        for nm, v in (("alpha", alpha), ("beta", beta), ("gamma", gamma)):
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{nm} must be in [0, 1], got {v}")
        self.season = int(season) if season and season >= 2 else 0
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.gamma = float(gamma)
        self.level: float | None = None
        self.trend = 0.0
        self.seasonal = np.zeros(self.season)
        self._t = 0
        self.name = (
            f"holt-winters(season={self.season})" if self.season else "holt"
        )

    def observe(self, load: float) -> None:
        x = float(load)
        if self.level is None:
            self.level = x
            self._t = 1
            return
        s_old = self.seasonal[self._t % self.season] if self.season else 0.0
        prev = self.level
        self.level = (
            self.alpha * (x - s_old)
            + (1.0 - self.alpha) * (self.level + self.trend)
        )
        self.trend = (
            self.beta * (self.level - prev) + (1.0 - self.beta) * self.trend
        )
        if self.season:
            self.seasonal[self._t % self.season] = (
                self.gamma * (x - self.level) + (1.0 - self.gamma) * s_old
            )
        self._t += 1

    def forecast(self, horizon: int) -> np.ndarray:
        h = _window(horizon)
        if self.level is None:
            return np.zeros(h)
        k = np.arange(1, h + 1, dtype=np.float64)
        out = self.level + k * self.trend
        if self.season:
            out = out + self.seasonal[
                (self._t + np.arange(h) ) % self.season
            ]
        return np.maximum(out, 0.0)

    def state_dict(self) -> dict:
        return {
            "has_level": 1 if self.level is not None else 0,
            "level": 0.0 if self.level is None else float(self.level),
            "trend": float(self.trend),
            "seasonal": np.asarray(self.seasonal, np.float64),
            "t": int(self._t),
        }

    def load_state_dict(self, state: dict) -> None:
        self.level = (
            float(state["level"]) if int(state["has_level"]) else None
        )
        self.trend = float(state["trend"])
        seasonal = np.asarray(state["seasonal"], np.float64)
        if seasonal.shape != (self.season,):
            raise ValueError(
                f"seasonal state has {seasonal.shape[0]} slots, forecaster "
                f"has season={self.season}"
            )
        self.seasonal = seasonal.copy()
        self._t = int(state["t"])


class ReplayForecaster:
    """Seasonal-naive history replay: load ``k`` steps ahead is forecast as
    the load observed one ``period`` earlier (wrapping back additional whole
    periods when the horizon outruns the history).  Before a full period of
    history the last observed value stands in — so the forecaster is
    total from the first sample and converges to exact replay on strictly
    periodic traces.
    """

    name = "replay"

    def __init__(self, period: int, max_history: int | None = None) -> None:
        if int(period) < 1:
            raise ValueError(f"period must be >= 1, got {period}")
        self.period = int(period)
        #: ring-buffer bound: keep at least 2 periods so wrap-back resolves
        self.max_history = max(
            int(max_history) if max_history else 4 * self.period,
            2 * self.period,
        )
        self.history: list[float] = []

    def observe(self, load: float) -> None:
        self.history.append(float(load))
        if len(self.history) > self.max_history:
            del self.history[: len(self.history) - self.max_history]

    def forecast(self, horizon: int) -> np.ndarray:
        h = _window(horizon)
        n = len(self.history)
        if n == 0:
            return np.zeros(h)
        out = np.empty(h)
        for k in range(h):
            idx = n + k - self.period
            while idx >= n:                      # horizon outruns history
                idx -= self.period
            out[k] = self.history[idx] if idx >= 0 else self.history[-1]
        return np.maximum(out, 0.0)

    def state_dict(self) -> dict:
        return {"history": np.asarray(self.history, np.float64)}

    def load_state_dict(self, state: dict) -> None:
        self.history = [
            float(x) for x in np.asarray(state["history"], np.float64)
        ]


#: Name → zero-config factory (period-bearing forecasters take the season).
FORECASTERS: dict[str, type] = {
    "last-value": LastValueForecaster,
    "holt-winters": HoltWintersForecaster,
    "replay": ReplayForecaster,
}


def make_forecaster(name: str, **kw) -> Forecaster:
    """Build a registered forecaster by name (``KeyError`` on unknown)."""
    if name not in FORECASTERS:
        raise KeyError(
            f"unknown forecaster {name!r}; available: {sorted(FORECASTERS)}"
        )
    return FORECASTERS[name](**kw)
