"""Stream-processing substrate on PyTorch: operators, the workload DAGs,
load sources, the batched discrete-time cluster simulator with its
cache-first services (in-batch dedup, result caches, device-resident
batches, lazy trajectory refetch), the real executor, and the engine
through which control layers evaluate configurations without knowing which
backend answers."""

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
    clear_dedup_stats,
    clear_kernel_cache,
    clear_resident_cache,
    clear_structure_cache,
    clear_transfer_stats,
    dedup_info,
    degree_bucket_size,
    edge_bucket_size,
    kernel_cache_info,
    measure_capacity,
    pad_structure,
    resident_cache_info,
    resolve_tick_kernel,
    shard_count,
    simulate,
    simulate_batch,
    simulate_grid,
    structure_cache_info,
    structure_for,
    training_sweep,
    transfer_info,
)
from .cache import (
    ResultCache,
    cache_stats,
    clear_result_caches,
    result_cache_info,
)
from .engine import (
    OVERLOAD_KTPS,
    ConfigEvaluator,
    EvalResult,
    ExecutorEvaluator,
    PerCandidateLoads,
    SimulatorEvaluator,
    evaluate_grid_with,
    evaluate_jobs_with,
)
from . import sources

__all__ = [
    "BATCH_LADDER", "BUCKET_LADDER", "DEGREE_LADDER", "EDGE_LADDER",
    "OVERLOAD_KTPS", "SAMPLES_MODES", "SPARSE_DENSITY_THRESHOLD",
    "ConfigEvaluator", "EvalResult", "ExecutorEvaluator", "PerCandidateLoads", "ResultCache",
    "SimParams", "SimResult", "SimStructure", "SimulatorEvaluator",
    "TrajectoryUnavailable", "WORKLOADS", "adanalytics",
    "batch_bucket_size", "bucket_size", "build_structure", "cache_stats",
    "clear_dedup_stats", "clear_kernel_cache", "clear_resident_cache",
    "clear_result_caches", "clear_structure_cache", "clear_transfer_stats",
    "dedup_info", "deep_pipeline", "degree_bucket_size", "diamond",
    "edge_bucket_size", "evaluate_grid_with", "evaluate_jobs_with",
    "kernel_cache_info", "measure_capacity", "mobile_analytics",
    "pad_structure", "resident_cache_info", "resolve_tick_kernel",
    "result_cache_info", "shard_count", "simulate", "simulate_batch",
    "simulate_grid", "sources", "structure_cache_info", "structure_for",
    "training_sweep", "transfer_info", "wordcount",
]
