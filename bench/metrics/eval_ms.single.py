"""Device ms per epoch of the phase span `eval`."""
from bench.lib import readers


def read(obs):
    return readers.span_per(obs, "eval", "epochs")
