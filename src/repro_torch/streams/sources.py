"""Load-trace generators (Trevor §2.3).

Streaming services see diurnal/weekly variation (LinkedIn 12.7→18 M ev/s,
Netflix 4.6→8 M ev/s), plus transient spikes up to 25× average lasting
minutes (World-Cup-goal effects).  These generators produce ktps traces used
by the autoscaler benchmarks and examples.
"""
from __future__ import annotations

import numpy as np


def diurnal(
    n: int,
    base_ktps: float = 400.0,
    peak_ratio: float = 3.0,
    period: int = 288,
    seed: int = 0,
    jitter: float = 0.05,
) -> np.ndarray:
    """Sinusoidal day curve: peak/average ≈ the paper's 3-5× daily pattern."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    day = 0.5 * (1 + np.sin(2 * np.pi * t / period - np.pi / 2))
    trace = base_ktps * (1.0 + (peak_ratio - 1.0) * day)
    return trace * (1.0 + jitter * rng.standard_normal(n))


def spike(
    n: int,
    base_ktps: float = 400.0,
    spike_ratio: float = 20.0,
    spike_start: int | None = None,
    spike_len: int = 6,
    seed: int = 0,
) -> np.ndarray:
    """A World-Cup-style transient: up to 20-25× the average for minutes."""
    rng = np.random.default_rng(seed)
    trace = base_ktps * (1.0 + 0.05 * rng.standard_normal(n))
    s = spike_start if spike_start is not None else n // 2
    ramp = np.linspace(1.0, spike_ratio, max(spike_len // 2, 1))
    down = np.linspace(spike_ratio, 1.0, max(spike_len - spike_len // 2, 1))
    prof = np.concatenate([ramp, down])
    e = min(s + prof.shape[0], n)
    trace[s:e] *= prof[: e - s]
    return trace


def weekly(
    n: int,
    base_ktps: float = 400.0,
    day_period: int = 288,
    seed: int = 0,
) -> np.ndarray:
    """Seven-day pattern with weekend dips (mobile-network style 1.6k→83k)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    day = 0.5 * (1 + np.sin(2 * np.pi * t / day_period - np.pi / 2))
    dow = (t // day_period) % 7
    weekend = np.where(dow >= 5, 0.6, 1.0)
    return base_ktps * (0.5 + 2.5 * day) * weekend * (1 + 0.04 * rng.standard_normal(n))
