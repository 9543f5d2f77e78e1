"""The model's operations (bench/costs/granite) in the profiled rounds over
their time and the bf16 peak."""
from bench.costs import granite
from bench.lib import readers


def read(obs):
    return readers.mfu_pct(obs, granite.token_flops(obs.config, obs.cell["traffic"]["seq"]),
                           "bf16")
