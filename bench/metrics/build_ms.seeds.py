"""Host ms per `engine.build_context` call inside `run_seeds` (one of the
S federations of a call)."""
from bench.lib import readers


def read(obs):
    return readers.host_mean(obs, "build_context")
