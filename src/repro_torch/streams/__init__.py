"""Stream-processing substrate on PyTorch: the workload DAGs and the batched
discrete-time cluster simulator.  The executor, the evaluator engine and
the result caches are not ported yet."""

from .workloads import (
    WORKLOADS,
    adanalytics,
    deep_pipeline,
    diamond,
    mobile_analytics,
    wordcount,
)
from .simulator import (
    BATCH_LADDER,
    BUCKET_LADDER,
    DEGREE_LADDER,
    EDGE_LADDER,
    SAMPLES_MODES,
    SPARSE_DENSITY_THRESHOLD,
    SimParams,
    SimResult,
    SimStructure,
    TrajectoryUnavailable,
    batch_bucket_size,
    bucket_size,
    build_structure,
    degree_bucket_size,
    edge_bucket_size,
    measure_capacity,
    pad_structure,
    resolve_tick_kernel,
    simulate,
    simulate_batch,
    simulate_grid,
    structure_for,
    training_sweep,
)

__all__ = [
    "BATCH_LADDER", "BUCKET_LADDER", "DEGREE_LADDER", "EDGE_LADDER",
    "SAMPLES_MODES", "SPARSE_DENSITY_THRESHOLD", "SimParams", "SimResult",
    "SimStructure", "TrajectoryUnavailable", "WORKLOADS", "adanalytics",
    "batch_bucket_size", "bucket_size", "build_structure", "deep_pipeline",
    "degree_bucket_size", "diamond", "edge_bucket_size", "measure_capacity",
    "mobile_analytics", "pad_structure", "resolve_tick_kernel", "simulate",
    "simulate_batch", "simulate_grid", "structure_for", "training_sweep",
    "wordcount",
]
