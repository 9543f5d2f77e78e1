"""Hand-written CUDA kernels for the port's hot paths (built at first use)."""
from . import gossip_mix  # noqa: F401
