"""The model's operations (bench/costs/moonlight: this chip's cut) in the
profiled rounds over their time and the bf16 peak."""
from bench.costs import moonlight
from bench.lib import readers


def read(obs):
    return readers.mfu_pct(obs, moonlight.token_flops(obs.config, obs.cell["traffic"]["seq"]),
                           "bf16")
