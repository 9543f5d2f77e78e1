"""Share of the profiled calls' host time with nothing on the device."""
from bench.lib import readers


def read(obs):
    return readers.idle_pct(obs)
