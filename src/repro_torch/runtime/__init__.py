"""Host-side runtime helpers: the straggler monitor, the fault-tolerant
training loop and the elastic restore onto a new mesh."""
from .elastic import ElasticRestore, best_mesh
from .fault import (FailureInjector, TrainLoopConfig, WorkerFailure,
                    run_with_restarts)
from .straggler import StragglerConfig, StragglerMonitor

__all__ = ["ElasticRestore", "FailureInjector", "StragglerConfig",
           "StragglerMonitor", "TrainLoopConfig", "WorkerFailure",
           "best_mesh", "run_with_restarts"]
