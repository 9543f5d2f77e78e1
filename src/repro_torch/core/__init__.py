"""Core DFL-DDS library: contacts, state vectors, P1 solver, aggregation."""
from . import aggregation, contacts, dfl_dds, kl_solver, state_vector  # noqa: F401
from .dfl_dds import FederationState, dds_round, init_federation  # noqa: F401
