"""Host ms per `engine.build_context` call (one federation's set-up: the
d_max probe, the partition, the data on the device, the model stack)."""
from bench.lib import readers


def read(obs):
    return readers.host_mean(obs, "build_context")
