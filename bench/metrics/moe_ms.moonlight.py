"""Device ms per round of the span `moe`: every MoE layer's router, held
experts and shared experts, forward and (under remat) recompute."""
from bench.lib import readers


def read(obs):
    return readers.span_per(obs, "moe", "rounds")
