from .optimizers import Optimizer, ScaleState, apply_updates, sgd  # noqa: F401
