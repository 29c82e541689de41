"""Trevor core on the host (numpy): learned performance models, the LP
data-flow solver and the balanced-container allocator.  A self-contained
copy of the reference package's core; calibration, the autoscaler and the
reactive scaler are not ported yet."""

from .dag import (
    Configuration,
    ContainerDim,
    DagSpec,
    EdgeSpec,
    Grouping,
    NodeSpec,
    propagate_rates,
    round_robin_configuration,
    single_container_configuration,
)
from .metrics import STREAM_MANAGER, InstanceSamples, MetricsStore
from .node_model import (
    LinearFit,
    NodeModel,
    ResourceClass,
    fit_node,
    fit_workload,
    linear_fit,
    oracle_models,
)
from .flow_solver import FlowSolution, build_flow_problem, classify_bound, solve_flow
from .allocator import (
    AllocationResult,
    BalancedContainer,
    BudgetedAllocation,
    ResourceBudget,
    allocate,
    allocate_point,
    allocate_under_budget,
    minimal_footprint,
)

__all__ = [
    "AllocationResult", "BalancedContainer", "BudgetedAllocation",
    "Configuration", "ContainerDim", "DagSpec", "EdgeSpec",
    "FlowSolution", "Grouping", "InstanceSamples", "LinearFit", "MetricsStore",
    "NodeModel", "NodeSpec", "ResourceBudget",
    "ResourceClass", "STREAM_MANAGER", "allocate", "allocate_point",
    "allocate_under_budget",
    "build_flow_problem", "classify_bound", "fit_node", "fit_workload",
    "linear_fit", "minimal_footprint", "oracle_models", "propagate_rates",
    "round_robin_configuration",
    "single_container_configuration", "solve_flow",
]
