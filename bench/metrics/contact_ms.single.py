"""Host ms per epoch in `engine.ContactStream.window` (mobility and the
neighbour lists)."""
from bench.lib import readers


def read(obs):
    return readers.host_per_epoch(obs, "contact_window")
