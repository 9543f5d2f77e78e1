"""Device ms per round of the train step's phase span `mix`."""
from bench.lib import readers


def read(obs):
    return readers.span_per(obs, "mix", "rounds")
