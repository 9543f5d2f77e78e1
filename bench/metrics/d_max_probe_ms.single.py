"""Host ms per `build_context` call in the d_max probe, from the program's
span `d_max_probe` (the contact stream replayed over the horizon)."""
from bench.lib import readers


def read(obs):
    return readers.span_per(obs, "d_max_probe.host", "calls")
