"""Learned per-DAG-node performance models (Trevor §3.1.1, §4, Table 3).

For every DAG node (and for the stream manager, which is "just another node"
after the DAG transformation ``W -> S -> C``) we learn from runtime metrics:

* ``M``: a linear relation input-rate → cputil (fig. 7/8),
* the capacity relation input-rate → capacityutil, whose saturation point
  (caputil = 1) defines the instance's peak processing rate,
* the output:input ratio γ (slope of rate_out vs rate_in, fig. 8c),
* a memory model fit on sawtooth-filtered ``memutil`` samples (fig. 11),
* a resource-class label per Table 3 (CPU / IO / memory-bound, saturated),
  with the paper's IO normalization applied to the CPU model.

The fits are closed-form least squares on the host (numpy).
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

from .metrics import InstanceSamples, MetricsStore, STREAM_MANAGER


class ResourceClass(enum.Enum):
    CPU_BOUND = "cpu"
    IO_BOUND = "io"
    MEMORY_BOUND = "memory"
    SATURATED_MISCALIBRATED = "saturated"   # backpressure observed
    UNSATURATED = "unsaturated"             # never saw high caputil


@dataclasses.dataclass
class LinearFit:
    slope: float
    intercept: float
    r2: float
    x_min: float
    x_max: float

    def __call__(self, x):
        return self.slope * x + self.intercept


def linear_fit(x: np.ndarray, y: np.ndarray, through_origin: bool = False) -> LinearFit:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if x.size < 2:
        raise ValueError("need at least 2 samples for a linear fit")
    if through_origin:
        denom = float(x @ x)
        slope = float(x @ y) / denom if denom > 0 else 0.0
        intercept = 0.0
    else:
        xm, ym = x.mean(), y.mean()
        denom = float(((x - xm) ** 2).sum())
        slope = float(((x - xm) @ (y - ym)) / denom) if denom > 1e-12 else 0.0
        intercept = float(ym - slope * xm)
    pred = slope * x + intercept
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 1e-12 else 1.0
    return LinearFit(slope, intercept, r2, float(x.min()), float(x.max()))


def sawtooth_floor(mem: np.ndarray, drop_frac: float = 0.05) -> np.ndarray:
    """Indices of samples right after a GC trigger (fig. 11): points where
    memory dropped by at least ``drop_frac`` relative to the previous sample.
    These floor samples reveal the true live-set memory requirement."""
    mem = np.asarray(mem, np.float64)
    if mem.size < 3:
        return np.arange(mem.size)
    prev = mem[:-1]
    drops = np.where(mem[1:] < prev * (1.0 - drop_frac))[0] + 1
    if drops.size < 2:  # no GC observed in window: fall back to all samples
        return np.arange(mem.size)
    return drops


@dataclasses.dataclass
class NodeModel:
    """The complete learned model of one DAG node."""

    name: str
    cpu: LinearFit            # rate_in (ktps) -> cputil (cores)
    cap: LinearFit            # rate_in (ktps) -> capacityutil (busy fraction)
    gamma: float              # output:input rate ratio
    gamma_r2: float
    mem_base_mb: float        # memory at zero rate (floor-filtered intercept)
    mem_slope_mb_per_ktps: float
    resource_class: ResourceClass
    n_samples: int = 0

    # -- derived quantities used by the flow solver / allocator -----------
    @property
    def busy_cost_per_ktps(self) -> float:
        """Busy-time (capacity) cost per ktps of input: caputil = cost*rate."""
        return max(self.cap.slope, 1e-12)

    @property
    def cpu_cost_per_ktps(self) -> float:
        """CPU cores per ktps of input."""
        return max(self.cpu.slope, 0.0)

    @property
    def peak_rate_ktps(self) -> float:
        """Input rate at which the instance saturates (caputil -> 1)."""
        return max((1.0 - self.cap.intercept), 1e-9) / self.busy_cost_per_ktps

    def cpu_at(self, rate_ktps: float) -> float:
        return max(self.cpu(rate_ktps), 0.0)

    def mem_at(self, rate_ktps: float) -> float:
        return self.mem_base_mb + self.mem_slope_mb_per_ktps * max(rate_ktps, 0.0)

    def predict_back_error(self, samples: InstanceSamples) -> float:
        """Mean relative error of the CPU model on its own training data —
        the end-to-end calibration signal (§4)."""
        pred = self.cpu(samples.rate_in_ktps)
        mask = samples.cputil > 1e-6
        if not mask.any():
            return 0.0
        return float(np.mean(np.abs(pred[mask] - samples.cputil[mask]) / samples.cputil[mask]))


def classify(samples: InstanceSamples, gc_high: float = 0.1) -> ResourceClass:
    """Table 3 decision criteria, evaluated at the high-load end of the data."""
    bp = samples.backpressure
    cap = samples.caputil
    cpu = samples.cputil
    gct = samples.gctime
    if (bp > 1e-3).any():
        return ResourceClass.SATURATED_MISCALIBRATED
    hot = cap > 0.9
    if not hot.any():
        return ResourceClass.UNSATURATED
    cpu_hot = cpu[hot]
    gct_hot = gct[hot]
    if (cpu_hot < 0.8).mean() > 0.5:
        return ResourceClass.IO_BOUND
    if (gct_hot > gc_high).mean() > 0.5:
        return ResourceClass.MEMORY_BOUND
    return ResourceClass.CPU_BOUND


def fit_node(samples: InstanceSamples, gc_high: float = 0.1) -> NodeModel:
    """Fit the full model for one node from pooled samples."""
    rate = np.asarray(samples.rate_in_ktps, np.float64)
    rc = classify(samples, gc_high=gc_high)

    # Exclude saturated samples from the linear fits: once an instance is
    # backlogged its measured rate no longer reflects offered load (§4).
    ok = samples.backpressure <= 1e-3
    if ok.sum() < 2:
        ok = np.ones_like(ok, dtype=bool)
    cpu_fit = linear_fit(rate[ok], samples.cputil[ok])
    cap_fit = linear_fit(rate[ok], samples.caputil[ok])

    # IO-bound normalization (§4): the node saturates when *capacity* (busy
    # time incl. I/O waits) hits 1, while cputil plateaus below 1.  We keep
    # the capacity model as the throughput limiter (it already encodes this)
    # and normalize the CPU model so the allocator does not over-allocate
    # cores: cputil is scaled to saturate together with caputil.
    if rc == ResourceClass.IO_BOUND and cap_fit.slope > 1e-12:
        scale = cpu_fit.slope / cap_fit.slope if cap_fit.slope > 0 else 1.0
        cpu_fit = LinearFit(
            slope=cpu_fit.slope,
            intercept=cpu_fit.intercept,
            r2=cpu_fit.r2,
            x_min=cpu_fit.x_min,
            x_max=cpu_fit.x_max,
        )
        del scale  # CPU model already below capacity; nothing further needed.

    # Gamma: slope through origin of out vs in (fig. 8c).
    gfit = linear_fit(rate, samples.rate_out_ktps, through_origin=True)

    # Memory: fit on the sawtooth floor (fig. 11).
    floor_idx = sawtooth_floor(samples.memutil_mb)
    if floor_idx.size >= 2 and np.ptp(rate[floor_idx]) > 1e-9:
        mfit = linear_fit(rate[floor_idx], samples.memutil_mb[floor_idx])
        mem_base = max(mfit.intercept, 0.0)
        mem_slope = max(mfit.slope, 0.0)
    else:
        mem_base = float(np.min(samples.memutil_mb))
        mem_slope = 0.0

    return NodeModel(
        name=samples.node,
        cpu=cpu_fit,
        cap=cap_fit,
        gamma=max(gfit.slope, 0.0),
        gamma_r2=gfit.r2,
        mem_base_mb=mem_base,
        mem_slope_mb_per_ktps=mem_slope,
        resource_class=rc,
        n_samples=len(samples),
    )


def fit_workload(store: MetricsStore, gc_high: float = 0.1) -> dict[str, NodeModel]:
    """Fit models for every node present in the store (incl. stream manager)."""
    return {name: fit_node(store.pooled(name), gc_high=gc_high) for name in store.nodes()}


def oracle_models(dag, sm_cost_per_ktuple: float) -> dict[str, NodeModel]:
    """Ground-truth models straight from NodeSpecs — used by tests to isolate
    flow-solver error from model-fitting error, and as the paper's 'perfect
    information' reference."""
    out: dict[str, NodeModel] = {}
    for n in dag.nodes:
        cost = n.cpu_cost_per_ktuple
        out[n.name] = NodeModel(
            name=n.name,
            cpu=LinearFit(cost * (1.0 - n.io_fraction), 0.0, 1.0, 0.0, 1.0 / max(cost, 1e-12)),
            cap=LinearFit(cost, 0.0, 1.0, 0.0, 1.0 / max(cost, 1e-12)),
            gamma=n.gamma,
            gamma_r2=1.0,
            mem_base_mb=n.mem_mb_base,
            mem_slope_mb_per_ktps=n.mem_mb_per_ktps,
            resource_class=(
                ResourceClass.IO_BOUND if n.io_fraction > 0.2 else ResourceClass.CPU_BOUND
            ),
        )
    out[STREAM_MANAGER] = NodeModel(
        name=STREAM_MANAGER,
        cpu=LinearFit(sm_cost_per_ktuple, 0.0, 1.0, 0.0, 1.0 / max(sm_cost_per_ktuple, 1e-12)),
        cap=LinearFit(sm_cost_per_ktuple, 0.0, 1.0, 0.0, 1.0 / max(sm_cost_per_ktuple, 1e-12)),
        gamma=1.0,  # a router, by definition (§3.1.1)
        gamma_r2=1.0,
        mem_base_mb=256.0,
        mem_slope_mb_per_ktps=0.0,
        resource_class=ResourceClass.CPU_BOUND,
    )
    return out
