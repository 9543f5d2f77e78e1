"""Device ms per round of the span `mla`: every layer's latent attention, its
forward and (under remat) its recompute, inside `local_train`."""
from bench.lib import readers


def read(obs):
    return readers.span_per(obs, "mla", "rounds")
