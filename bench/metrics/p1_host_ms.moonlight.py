"""Host ms per round inside the train step's phase span `p1_solve`."""
from bench.lib import readers


def read(obs):
    return readers.span_per(obs, "p1_solve.host", "rounds")
