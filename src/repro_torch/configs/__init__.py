"""Architecture presets: copies of ``repro.configs`` (pure data), so that
``get_config(name)`` resolves the same ids in the port."""
from .base import ArchConfig
from .registry import (ALL_CONFIGS, ARCHITECTURES, PAPER_MODELS, PORT_ONLY,
                       assigned_architectures, get_config)

__all__ = [
    "ArchConfig", "ALL_CONFIGS", "ARCHITECTURES", "PAPER_MODELS", "PORT_ONLY",
    "assigned_architectures", "get_config",
]
