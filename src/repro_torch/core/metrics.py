"""Runtime-metric schema (Trevor §4, "Metrics").

The Heron runtime exposes, per node instance and per stream manager:
``backpressure`` (time spent backlogged), ``capacityutil`` (fraction of time
busy processing), ``cputil``/``memutil`` (resource utilization) and ``gctime``
(JVM garbage-collection time).  Per edge it exposes tuple rates.

The simulator (:mod:`repro_torch.streams.simulator`) emits these samples; the model
trainer (:mod:`repro_torch.core.node_model`) consumes them.  Nothing in here is
workload-specific.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class InstanceSamples:
    """Timeseries of metric samples for one node-instance (or one stream
    manager, which Trevor treats as just another DAG node)."""

    node: str
    container: int
    slot: int
    # All arrays share the same length (one entry per sampling interval).
    rate_in_ktps: np.ndarray      # input tuple rate
    rate_out_ktps: np.ndarray     # output tuple rate
    cputil: np.ndarray            # CPU cores consumed (can exceed 1.0, §3.1.1)
    caputil: np.ndarray           # fraction of time busy (capacityutil)
    memutil_mb: np.ndarray        # resident memory (sawtooth, fig. 11)
    gctime: np.ndarray            # GC time fraction
    backpressure: np.ndarray      # backpressure time fraction

    def __post_init__(self) -> None:
        n = len(self.rate_in_ktps)
        for f in (
            "rate_out_ktps", "cputil", "caputil", "memutil_mb", "gctime", "backpressure",
        ):
            if len(getattr(self, f)) != n:
                raise ValueError(f"metric field {f} length mismatch")

    def __len__(self) -> int:
        return len(self.rate_in_ktps)


@dataclasses.dataclass
class MetricsStore:
    """All samples collected from one (or more) deployments of a workload.

    Samples for the same logical node from different instances/deployments are
    pooled for model fitting — exactly the paper's "keep pooling metrics and
    improve model performance" loop (§4).
    """

    samples: list[InstanceSamples] = dataclasses.field(default_factory=list)

    def add(self, s: InstanceSamples) -> None:
        self.samples.append(s)

    def extend(self, other: "MetricsStore") -> None:
        self.samples.extend(other.samples)

    def nodes(self) -> list[str]:
        return sorted({s.node for s in self.samples})

    def pooled(self, node: str) -> InstanceSamples:
        """Concatenate every instance's samples for ``node``."""
        subset = [s for s in self.samples if s.node == node]
        if not subset:
            raise KeyError(f"no samples for node {node!r}")
        cat = lambda f: np.concatenate([getattr(s, f) for s in subset])
        return InstanceSamples(
            node=node,
            container=-1,
            slot=-1,
            rate_in_ktps=cat("rate_in_ktps"),
            rate_out_ktps=cat("rate_out_ktps"),
            cputil=cat("cputil"),
            caputil=cat("caputil"),
            memutil_mb=cat("memutil_mb"),
            gctime=cat("gctime"),
            backpressure=cat("backpressure"),
        )

    def __len__(self) -> int:
        return len(self.samples)


STREAM_MANAGER = "__stream_manager__"
