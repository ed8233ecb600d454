"""Optimiser and learning-rate schedules (the port of ``repro.optim``)."""
from .adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from .schedule import cosine_schedule, wsd_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "wsd_schedule", "cosine_schedule"]
