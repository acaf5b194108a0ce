"""Optimizers (port of `repro.optim`): AdamW, the schedules, and
error-feedback int8 gradient compression (`grad_comp`)."""
from . import grad_comp, schedule
from .adam import AdamState, AdamW, global_norm

__all__ = ["AdamState", "AdamW", "global_norm", "grad_comp", "schedule"]
