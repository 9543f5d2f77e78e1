"""AdamW as one in-place multi-tensor launch per vehicle step: the
hand-written Hopper kernel the train step calls on the card
(``launch.steps.adamw_step_``; its plain version is ``steps.adamw_per_leaf_``)."""
from .kernel import adamw_  # noqa: F401
