"""Trevor core on the host (numpy): learned performance models, the LP
data-flow solver, the balanced-container allocator, predict-back
calibration, the declarative autoscaler and the Dhalion-style reactive
scaler.  A self-contained copy of the reference package's core, with its
batch paths in PyTorch on the card (``node_model.fit_many_torch``,
``lp.torch_linprog``).  The LM bridge (``core.lm_bridge``) is imported
from its module, as in the reference."""

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
from .calibration import Calibrator
from .autoscaler import AutoScaler, run_against_trace
from .reactive import ReactiveResult, reactive_scale

__all__ = [
    "AllocationResult", "AutoScaler", "BalancedContainer", "BudgetedAllocation",
    "Calibrator", "Configuration", "ContainerDim", "DagSpec", "EdgeSpec",
    "FlowSolution", "Grouping", "InstanceSamples", "LinearFit", "MetricsStore",
    "NodeModel", "NodeSpec", "ReactiveResult", "ResourceBudget",
    "ResourceClass", "STREAM_MANAGER", "allocate", "allocate_point",
    "allocate_under_budget",
    "build_flow_problem", "classify_bound", "fit_node", "fit_workload",
    "linear_fit", "minimal_footprint", "oracle_models", "propagate_rates",
    "reactive_scale", "round_robin_configuration", "run_against_trace",
    "single_container_configuration", "solve_flow",
]
