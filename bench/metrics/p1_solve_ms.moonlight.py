"""Device ms per round of the train step's phase span `p1_solve`."""
from bench.lib import readers


def read(obs):
    return readers.span_per(obs, "p1_solve", "rounds")
