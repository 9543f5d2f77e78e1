from . import schedules
from .optimizers import (
    AdamState, MomentumState, Optimizer, ScaleState, adam_bias_corrections, adamw,
    apply_updates, clip_by_global_norm, global_norm, momentum, sgd,
)

__all__ = [
    "schedules", "Optimizer", "ScaleState", "MomentumState", "AdamState",
    "sgd", "momentum", "adamw", "adam_bias_corrections", "apply_updates", "global_norm",
    "clip_by_global_norm",
]
