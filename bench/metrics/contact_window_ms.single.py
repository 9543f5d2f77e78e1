"""Host ms per epoch in `ContactStream.window`, from the program's span
`contact_window` (mobility and the neighbour lists, on the host)."""
from bench.lib import readers


def read(obs):
    return readers.span_per(obs, "contact_window.host", "epochs")
