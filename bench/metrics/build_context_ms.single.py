"""Host ms per `engine.build_context` call, from the program's span
`build_context` (the d_max probe, the partition, the data on the device, the
model stack)."""
from bench.lib import readers


def read(obs):
    return readers.span_per(obs, "build_context.host", "calls")
