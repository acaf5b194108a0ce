"""Optimizers (port of `repro.optim`: AdamW and the schedules).
`grad_comp` comes with the sharded-training slice."""
from . import schedule
from .adam import AdamState, AdamW, global_norm

__all__ = ["AdamState", "AdamW", "global_norm", "schedule"]
