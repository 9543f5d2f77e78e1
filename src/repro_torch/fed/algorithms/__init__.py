"""Registered federation algorithms (see base.Algorithm for the protocol).

Importing this package registers the built-ins: the paper's three
(``dds`` / ``dfl`` / ``sp``) and the beyond-paper baselines
(``d_fedavg`` / ``d_sgd``). The engine resolves ``SimulationConfig.algorithm``
through ``get_algorithm``.
"""
from .base import (  # noqa: F401
    Algorithm,
    AlgorithmSetup,
    available_algorithms,
    get_algorithm,
    register_algorithm,
)
from . import d_fedavg, d_sgd, dds, dfl, sp  # noqa: F401  (registration)
