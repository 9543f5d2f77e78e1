"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

from .base import ArchConfig
from .granite_34b import CONFIG as GRANITE_34B
from .granite_moe_1b_a400m import CONFIG as GRANITE_MOE
from .hymba_1_5b import CONFIG as HYMBA
from .internvl2_26b import CONFIG as INTERNVL2
from .mixtral_8x7b import CONFIG as MIXTRAL
from .moonlight_16b_a3b import CONFIG as MOONLIGHT
from .musicgen_large import CONFIG as MUSICGEN
from .paper_cnns import CIFAR_CNN, MNIST_CNN
from .qwen1_5_4b import CONFIG as QWEN15_4B
from .qwen2_5_3b import CONFIG as QWEN25_3B
from .qwen3_1_7b import CONFIG as QWEN3_17B
from .rwkv6_3b import CONFIG as RWKV6_3B

ARCHITECTURES: dict[str, ArchConfig] = {
    c.name: c for c in [
        QWEN15_4B, QWEN25_3B, HYMBA, INTERNVL2, QWEN3_17B,
        MUSICGEN, GRANITE_MOE, GRANITE_34B, RWKV6_3B, MIXTRAL,
    ]
}

PAPER_MODELS: dict[str, ArchConfig] = {c.name: c for c in [MNIST_CNN, CIFAR_CNN]}

ALL_CONFIGS = {**ARCHITECTURES, **PAPER_MODELS}

# architectures of the port alone (the JAX package has no counterpart): they
# train through the same steps; the lists above stay the JAX package's
PORT_ONLY: dict[str, ArchConfig] = {c.name: c for c in [MOONLIGHT]}


def get_config(name: str) -> ArchConfig:
    found = ALL_CONFIGS.get(name) or PORT_ONLY.get(name)
    if found is None:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{sorted(ALL_CONFIGS) + sorted(PORT_ONLY)}")
    return found


def assigned_architectures() -> list[str]:
    """The 10 pool-assigned architecture ids (excl. the paper's own CNNs)."""
    return list(ARCHITECTURES)
