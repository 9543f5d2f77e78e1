from . import schedules
from .optimizers import (
    AdamState, MomentumState, Optimizer, ScaleState, adamw, apply_updates,
    clip_by_global_norm, global_norm, momentum, sgd,
)

__all__ = [
    "schedules", "Optimizer", "ScaleState", "MomentumState", "AdamState",
    "sgd", "momentum", "adamw", "apply_updates", "global_norm", "clip_by_global_norm",
]
