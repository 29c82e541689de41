from .elastic import ElasticController, ElasticEvent, FleetElasticController
from .fault import FailurePlan, InjectedFailure, StragglerMonitor, run_with_restarts

__all__ = [
    "ElasticController", "ElasticEvent", "FailurePlan", "FleetElasticController",
    "InjectedFailure", "StragglerMonitor", "run_with_restarts",
]
