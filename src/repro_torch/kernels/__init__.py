"""Hand-written CUDA kernels for the port's hot paths (built at first use)."""
from . import build as build_lib
from . import adamw, flash_attention, gossip_mix, grouped_mm, kl_simplex  # noqa: F401

KERNEL_MODULES = (gossip_mix.kernel, kl_simplex.kernel, flash_attention.kernel,
                  grouped_mm.kernel, adamw.kernel)


def build_all() -> None:
    """Compile every kernel of the port at once (one ``nvcc`` per source, all
    started together) and bind them; a no-op for what is already built."""
    build_lib.load_libraries([source for module in KERNEL_MODULES
                              for source in module.SOURCES.values()])
    for module in KERNEL_MODULES:
        module.build()


def reset_launch_counts() -> None:
    for module in KERNEL_MODULES:
        module.reset_launch_counts()
