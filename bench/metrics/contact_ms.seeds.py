"""Host ms per batched epoch in `engine.ContactStream.window`, over the S
streams of a call."""
from bench.lib import readers


def read(obs):
    return readers.host_per_epoch(obs, "contact_window")
