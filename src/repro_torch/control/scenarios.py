"""Load-scenario library: diverse traffic shapes for every policy (§2.3).

Phoebe's lesson (PAPERS.md) is that anticipating dynamic load needs
scenario-*diverse* traces, not one canonical curve.  This module is the
control plane's trace library: every generator takes ``(n, base_ktps,
seed, **kw)`` and returns a ktps array, and the :data:`SCENARIOS` registry
lets tests/benchmarks sweep policies over every shape by name.

The primitives build on :mod:`repro_torch.streams.sources` (diurnal, spike,
weekly — the paper's LinkedIn/Netflix/World-Cup patterns) and add the
shapes an autoscaler must also survive: flash crowds on top of a daily
curve, sustained ramps, step changes, sawtooth catch-up cycles, seeded
random bursts, and replay of recorded traces.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from ..streams import sources


def diurnal(n: int, base_ktps: float = 400.0, seed: int = 0,
            peak_ratio: float = 3.0, period: int | None = None) -> np.ndarray:
    """The paper's daily 3-5x curve (LinkedIn 12.7→18 M ev/s)."""
    period = period if period is not None else max(n // 2, 4)
    return sources.diurnal(n, base_ktps=base_ktps, peak_ratio=peak_ratio,
                           period=period, seed=seed)


def flash_crowd(n: int, base_ktps: float = 400.0, seed: int = 0,
                peak_ratio: float = 3.0, spike_ratio: float = 12.0,
                spike_start: int | None = None,
                spike_len: int | None = None) -> np.ndarray:
    """A World-Cup-goal transient riding on the daily curve: the hardest
    realistic shape (§2.3's 20-25x-for-minutes events)."""
    spike_len = spike_len if spike_len is not None else max(n // 8, 2)
    day = diurnal(n, base_ktps=base_ktps, seed=seed, peak_ratio=peak_ratio)
    burst = sources.spike(n, base_ktps=base_ktps, spike_ratio=spike_ratio,
                          spike_start=spike_start, spike_len=spike_len,
                          seed=seed + 1)
    return np.maximum(day, burst)


def ramp(n: int, base_ktps: float = 400.0, seed: int = 0,
         ratio: float = 4.0, jitter: float = 0.03) -> np.ndarray:
    """Sustained organic growth: load climbs ``ratio``x over the window."""
    rng = np.random.default_rng(seed)
    trace = np.linspace(base_ktps, base_ktps * ratio, n)
    return trace * (1.0 + jitter * rng.standard_normal(n))


def step(n: int, base_ktps: float = 400.0, seed: int = 0,
         levels: tuple[float, ...] = (1.0, 2.5, 1.5, 4.0),
         jitter: float = 0.02) -> np.ndarray:
    """Piecewise-constant level shifts (feature launches, failovers)."""
    rng = np.random.default_rng(seed)
    reps = -(-n // len(levels))
    trace = base_ktps * np.repeat(np.asarray(levels, np.float64), reps)[:n]
    return trace * (1.0 + jitter * rng.standard_normal(n))


def weekly(n: int, base_ktps: float = 400.0, seed: int = 0,
           day_period: int | None = None) -> np.ndarray:
    """Seven-day pattern with weekend dips."""
    day_period = day_period if day_period is not None else max(n // 7, 4)
    return sources.weekly(n, base_ktps=base_ktps, day_period=day_period, seed=seed)


def sawtooth(n: int, base_ktps: float = 400.0, seed: int = 0,
             ratio: float = 3.0, period: int | None = None,
             jitter: float = 0.02) -> np.ndarray:
    """Linear climb to ``ratio``x then an instant reset, repeating — the
    queue-drain / batch-ingest shape (a backlog consumer catches up, the
    feed resets).  Stresses the anti-thrash guards: the slow rise wants
    scale-ups, the cliff wants an immediate scale-down every period."""
    rng = np.random.default_rng(seed)
    period = period if period is not None else max(n // 4, 2)
    phase = (np.arange(n) % period) / max(period - 1, 1)
    trace = base_ktps * (1.0 + (ratio - 1.0) * phase)
    return trace * (1.0 + jitter * rng.standard_normal(n))


def bursty(n: int, base_ktps: float = 400.0, seed: int = 0,
           burst_ratio: float = 6.0, burst_prob: float = 0.05,
           burst_len: int | None = None, jitter: float = 0.05) -> np.ndarray:
    """Seeded-noise bursts: short high-rate events arrive at random (one
    seeded draw per step) on a noisy floor and decay geometrically — spiky,
    unpredictable traffic with no diurnal structure (the adversarial case
    for predictive policies; a best-effort tenant's natural shape)."""
    rng = np.random.default_rng(seed)
    burst_len = burst_len if burst_len is not None else max(n // 32, 2)
    trace = base_ktps * (1.0 + jitter * rng.standard_normal(n))
    envelope = np.zeros(n)
    decay = np.exp(-np.arange(n) / max(burst_len, 1))
    for start in np.flatnonzero(rng.random(n) < burst_prob):
        tail = n - start
        height = base_ktps * burst_ratio * (0.5 + 0.5 * rng.random())
        envelope[start:] = np.maximum(envelope[start:], height * decay[:tail])
    return np.maximum(trace, envelope)


def replay(trace, n: int | None = None, base_ktps: float | None = None) -> np.ndarray:
    """Replay a recorded trace: resampled to ``n`` points (linear
    interpolation) and rescaled so its mean is ``base_ktps`` — lets any
    production recording drive every policy at a comparable operating
    point."""
    src = np.asarray(trace, np.float64)
    if src.ndim != 1 or src.size < 2:
        raise ValueError("replay needs a 1-D trace with >= 2 samples")
    if n is not None and n != src.size:
        x_new = np.linspace(0.0, 1.0, n)
        x_old = np.linspace(0.0, 1.0, src.size)
        src = np.interp(x_new, x_old, src)
    if base_ktps is not None:
        mean = float(src.mean())
        if mean > 0:
            src = src * (base_ktps / mean)
    return src


#: Name → generator registry: every entry takes (n, base_ktps=..., seed=...).
SCENARIOS: dict[str, Callable[..., np.ndarray]] = {
    "diurnal": diurnal,
    "flash_crowd": flash_crowd,
    "ramp": ramp,
    "step": step,
    "weekly": weekly,
    "sawtooth": sawtooth,
    "bursty": bursty,
}

#: Scenario-conditioned guard-band presets, registered alongside the trace
#: generators and consumed through ``GuardBands.for_scenario(name)``.  The
#: tuning follows the shape: ``step``'s clean level shifts warrant a tight
#: deadband and symmetric release (follow the shift immediately, both ways);
#: ``flash_crowd``/``bursty`` transients warrant extra headroom, a wider
#: deadband and deep scale-down hysteresis (don't chase a spike back down);
#: periodic shapes sit at the defaults with moderately reluctant release.
GUARD_PRESETS: dict[str, dict] = {
    "diurnal": dict(headroom=1.2, deadband=0.15, down_hysteresis=2.0),
    "weekly": dict(headroom=1.2, deadband=0.15, down_hysteresis=2.5),
    "ramp": dict(headroom=1.25, deadband=0.10, down_hysteresis=2.0),
    "step": dict(headroom=1.2, deadband=0.05, down_hysteresis=1.0),
    "sawtooth": dict(headroom=1.2, deadband=0.10, down_hysteresis=3.0),
    "flash_crowd": dict(headroom=1.3, deadband=0.20, down_hysteresis=4.0),
    "bursty": dict(headroom=1.35, deadband=0.25, down_hysteresis=4.0),
}


# -- failure traces ----------------------------------------------------------
#
# Load shapes stress the *demand* side; failure traces stress the *supply*
# side.  A failure trace is a tuple of ``(step, kind, target)`` host
# lifecycle events for a fleet controller, covering the three shapes a
# failure-domain-aware fleet must survive: one host dying, a whole rack going dark (correlated failure),
# and a host flapping up/down faster than anyone can drain it.


def single_host_failure(
    n: int, host: str, fail_at: int | None = None,
    recover_after: int | None = None,
) -> tuple[tuple[int, str, str], ...]:
    """One host dies mid-trace (default: a third of the way in) and — when
    ``recover_after`` is given — comes back that many steps later.  The
    canonical N+1 scenario: survivors must hold the SLA for the failure
    step, the forced replan refits by the next one."""
    fail_at = fail_at if fail_at is not None else max(n // 3, 1)
    if not 0 <= fail_at < n:
        raise ValueError(f"fail_at={fail_at} outside the {n}-step trace")
    events = [(fail_at, "fail", host)]
    if recover_after is not None:
        back = fail_at + int(recover_after)
        if back < n:
            events.append((back, "recover", host))
    return tuple(events)


def rack_failure(
    n: int, rack: str, fail_at: int | None = None,
    recover_after: int | None = None,
) -> tuple[tuple[int, str, str], ...]:
    """Every host in one failure domain dies at once (switch/PDU loss) —
    the correlated case host-level spread cannot absorb; only rack-level
    anti-affinity keeps a guaranteed tenant serving through it."""
    fail_at = fail_at if fail_at is not None else max(n // 3, 1)
    if not 0 <= fail_at < n:
        raise ValueError(f"fail_at={fail_at} outside the {n}-step trace")
    events = [(fail_at, "fail-rack", rack)]
    if recover_after is not None:
        back = fail_at + int(recover_after)
        if back < n:
            events.append((back, "recover-rack", rack))
    return tuple(events)


def flapping_host(
    n: int, host: str, period: int = 2, start: int | None = None,
) -> tuple[tuple[int, str, str], ...]:
    """A host alternates failed/recovered every ``period`` steps from
    ``start`` to the end of the trace — the pathological shape for warm
    placement (the scheduler must neither chase the flapper nor wedge on
    it; every failure epoch still ends with zero containers on it)."""
    if period < 1:
        raise ValueError(f"period must be >= 1, got {period}")
    start = start if start is not None else max(n // 4, 1)
    events = []
    up = True
    for s in range(start, n, period):
        events.append((s, "fail" if up else "recover", host))
        up = not up
    return tuple(events)


#: Name → failure-trace generator: every entry takes ``(n, ...)`` and
#: returns ``(step, kind, target)`` host lifecycle events.
FAILURE_SCENARIOS: dict[str, Callable[..., tuple]] = {
    "single_host": single_host_failure,
    "rack": rack_failure,
    "flapping": flapping_host,
}


def make_failure_trace(name: str, n: int, **kw) -> tuple:
    """Build a named failure trace; raises ``KeyError`` for unknown names."""
    if name not in FAILURE_SCENARIOS:
        raise KeyError(
            f"unknown failure scenario {name!r}; "
            f"available: {sorted(FAILURE_SCENARIOS)}"
        )
    return FAILURE_SCENARIOS[name](n, **kw)


def make_trace(name: str, n: int, base_ktps: float = 400.0, seed: int = 0,
               split: float | int | None = None, **kw):
    """Build a named scenario trace; raises ``KeyError`` for unknown names.

    ``split`` carves the trace into a ``(train, test)`` pair — a fraction
    in (0, 1) or an absolute prefix length — so forecasters are fit on the
    train prefix and scored on a held-out suffix instead of leaking the
    full trace into their history."""
    if name not in SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r}; available: {sorted(SCENARIOS)}"
        )
    trace = SCENARIOS[name](n, base_ktps=base_ktps, seed=seed, **kw)
    if split is None:
        return trace
    k = int(round(split * n)) if isinstance(split, float) else int(split)
    if not 0 < k < n:
        raise ValueError(
            f"split={split!r} leaves an empty train or test side of a "
            f"{n}-sample trace"
        )
    return trace[:k], trace[k:]
