from . import (autotune, engine, equalizer, fir, qat, seqlen_opt,
               stream_partition, timing_model, train_eq, volterra)
from .engine import EqualizerEngine
from .equalizer import CNNEqConfig
from .fir import FIRConfig
from .qat import QATConfig
from .volterra import VolterraConfig

__all__ = ["CNNEqConfig", "EqualizerEngine", "FIRConfig", "QATConfig",
           "VolterraConfig", "autotune", "engine", "equalizer", "fir", "qat",
           "seqlen_opt", "stream_partition", "timing_model", "train_eq",
           "volterra"]
