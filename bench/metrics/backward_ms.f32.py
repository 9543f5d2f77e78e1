"""Device ms per round of the train step's span `backward`
(`torch.autograd.grad`; under remat with the recomputed forward), inside
`local_train`."""
from bench.lib import readers


def read(obs):
    return readers.span_per(obs, "backward", "rounds")
