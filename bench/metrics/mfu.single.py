"""The CNN's operations (bench/costs/cnn) in the profiled federations over
their time and the TF32 peak."""
from bench.costs import cnn
from bench.lib import readers


def read(obs):
    h = obs.cell["traffic"]["horizon_epochs"]
    return readers.mfu_pct(obs, cnn.federation_flops(obs.config, h) / h, "tf32")
