"""Host ms per epoch inside the phase span `p1_solve`: the time the host
spends launching the P1 solve, beside its device time (`p1_solve_ms.single`)."""
from bench.lib import readers


def read(obs):
    return readers.span_per(obs, "p1_solve.host", "epochs")
