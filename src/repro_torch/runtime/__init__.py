from .fault import FailurePlan, InjectedFailure, StragglerMonitor, run_with_restarts

__all__ = [
    "FailurePlan", "InjectedFailure", "StragglerMonitor", "run_with_restarts",
]
