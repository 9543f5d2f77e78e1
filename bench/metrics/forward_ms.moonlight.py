"""Device ms per round of the train step's span `forward` (the loss, its
bf16 casts included), inside `local_train`."""
from bench.lib import readers


def read(obs):
    return readers.span_per(obs, "forward", "rounds")
