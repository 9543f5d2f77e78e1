"""Device ms per round of the train step's phase span `local_train`."""
from bench.lib import readers


def read(obs):
    return readers.span_per(obs, "local_train", "rounds")
