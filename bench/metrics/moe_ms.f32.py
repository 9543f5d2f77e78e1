"""Device ms per round of the span `moe`: every layer's dense MoE (all 32
experts), forward and (under remat) recompute."""
from bench.lib import readers


def read(obs):
    return readers.span_per(obs, "moe", "rounds")
