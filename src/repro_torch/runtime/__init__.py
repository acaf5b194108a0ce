"""Host-side runtime helpers: the straggler monitor and the fault-tolerant
training loop (the elastic loop is not ported)."""
from .fault import (FailureInjector, TrainLoopConfig, WorkerFailure,
                    run_with_restarts)
from .straggler import StragglerConfig, StragglerMonitor

__all__ = ["FailureInjector", "StragglerConfig", "StragglerMonitor",
           "TrainLoopConfig", "WorkerFailure", "run_with_restarts"]
