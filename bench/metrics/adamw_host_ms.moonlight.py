"""Host ms per round inside the train step's span `adamw`: the time the
host spends launching the leaf-by-leaf update."""
from bench.lib import readers


def read(obs):
    return readers.span_per(obs, "adamw.host", "rounds")
