"""Host-side runtime helpers (the elastic and fault loops are not ported)."""
from .straggler import StragglerConfig, StragglerMonitor

__all__ = ["StragglerConfig", "StragglerMonitor"]
