"""Registered federation algorithms (see base.Algorithm for the protocol).

Importing this package registers the built-ins. Only ``dds`` (the paper's
algorithm) is ported so far; the engine resolves
``SimulationConfig.algorithm`` through ``get_algorithm``.
"""
from .base import (  # noqa: F401
    Algorithm,
    AlgorithmSetup,
    available_algorithms,
    get_algorithm,
    register_algorithm,
)
from . import dds  # noqa: F401  (registration)
