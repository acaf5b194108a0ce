from . import autotune, engine, equalizer, fir, qat, train_eq, volterra
from .engine import EqualizerEngine
from .equalizer import CNNEqConfig
from .fir import FIRConfig
from .qat import QATConfig
from .volterra import VolterraConfig

__all__ = ["CNNEqConfig", "EqualizerEngine", "FIRConfig", "QATConfig",
           "VolterraConfig", "autotune", "engine", "equalizer", "fir", "qat",
           "train_eq", "volterra"]
