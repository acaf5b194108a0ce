from . import autotune, engine, equalizer, qat
from .engine import EqualizerEngine
from .equalizer import CNNEqConfig
from .qat import QATConfig

__all__ = ["CNNEqConfig", "EqualizerEngine", "QATConfig", "autotune",
           "engine", "equalizer", "qat"]
