"""Device ms per epoch of the phase span `p1_solve`."""
from bench.lib import readers


def read(obs):
    return readers.span_per(obs, "p1_solve", "epochs")
