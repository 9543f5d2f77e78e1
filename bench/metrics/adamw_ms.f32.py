"""Device ms per round of the train step's span `adamw` (the leaf-by-leaf
AdamW update), inside `local_train`."""
from bench.lib import readers


def read(obs):
    return readers.span_per(obs, "adamw", "rounds")
