"""The model's operations (bench/costs/granite) in the profiled rounds over
their time and the f32 peak (the cell computes in f32, TF32 off)."""
from bench.costs import granite
from bench.lib import readers


def read(obs):
    return readers.mfu_pct(obs, granite.token_flops(obs.config, obs.cell["traffic"]["seq"]),
                           "f32")
