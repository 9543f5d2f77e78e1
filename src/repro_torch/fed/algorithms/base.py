"""The Algorithm protocol and the string-keyed algorithm registry.

An *algorithm* is everything the engine needs to run one federation round,
bundled behind four hooks:

* ``init_state(setup)``   — the stacked federation state;
* ``round(setup, state, contacts_t, target, batch, generator, fed_data)`` —
  one synchronized global iteration, returning ``(state, diags)`` with at
  least ``entropy`` / ``kl_divergence`` / ``loss`` diagnostics;
* ``sample(setup, fed_data, generator)`` — the per-epoch device-side batch;
* ``model_of(setup, state)``      — the evaluable parameter stack;
* ``state_spec(setup)``     — which state leaves are row-sharded under the
  shard_map backend (``core.vehicle_axis.ROW``: the big ``[K, ...]``
  stacks) and which every shard holds whole (``REPLICATED``: the tiny
  ``[K, K]`` matrices, counters) — the reference's ``state_pspec``.

``AlgorithmSetup`` carries the per-run context the engine builds once
(``engine.build_context``): config, local-train fn, initial stacks, the
resolved gossip-mix fn, and the vehicle-axis sharding regime. The shard_map
backend rebinds ``shard`` (and wraps ``mix_params_fn``) without the
algorithm knowing which backend it runs under.

Registering a new algorithm makes it addressable by name from
``SimulationConfig.algorithm`` with zero engine edits:

    @register_algorithm
    class MyAlgo(Algorithm):
        name = "my_algo"
        ...
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from ...core.vehicle_axis import GLOBAL, REPLICATED, ROW, VehicleSharding
from ...data import pipeline
from ...profiling import PhaseTimer

Tensor = torch.Tensor


@dataclass(frozen=True)
class AlgorithmSetup:
    """Per-run context shared by every algorithm hook; built once per
    (config, seed) by ``engine.build_context``, rebound (new ``shard`` and
    wrapped ``mix_params_fn``) by the shard_map backend."""
    cfg: Any                        # SimulationConfig (duck-typed; no engine import)
    total_nodes: int                # vehicles + RSUs
    loss_fn: Callable               # loss(params, x, y, generator) -> [K] losses
    local_train_fn: Callable        # E local SGD steps for the whole stack
    params_stack: dict              # [K, ...] identical-init model stack
    opt_stack: Any                  # [K, ...] optimizer state stack
    local_mask: Tensor | None       # [K] 1 = runs local iterations (RSUs 0)
    mix_params_fn: Callable         # resolved gossip mix (torch | cuda | shard-wrapped)
    timer: PhaseTimer | None = None  # per-phase timing, when a caller asks
    shard: VehicleSharding = field(default=GLOBAL)


class Algorithm:
    """Base class for registered algorithms (see module docstring)."""

    name: str = "?"

    def init_state(self, setup: AlgorithmSetup):
        raise NotImplementedError

    def round(self, setup: AlgorithmSetup, state, contacts_t, target: Tensor,
              batch, generator, fed_data: pipeline.FederatedData) -> tuple[Any, dict]:
        raise NotImplementedError

    def sample(self, setup: AlgorithmSetup, fed_data: pipeline.FederatedData,
               generator):
        """Default: per-vehicle [E, B] minibatches from the partition table
        (the full pick tensor drawn before any shard slice: the random
        streams are the same under every backend)."""
        cfg = setup.cfg
        if setup.shard.is_sharded:
            return pipeline.sample_batches_sliced(
                fed_data, generator, cfg.local_steps, cfg.batch_size,
                take_rows=setup.shard.local_rows)
        return pipeline.sample_batches(fed_data, generator, cfg.local_steps,
                                       cfg.batch_size)

    def model_of(self, setup: AlgorithmSetup, state):
        raise NotImplementedError

    def state_spec(self, setup: AlgorithmSetup):
        raise NotImplementedError


def federation_state_spec(setup: AlgorithmSetup):
    """The layout of a ``dfl_dds.FederationState``: params / optimizer
    stacks row-sharded, [K, K] state matrix + epoch counter replicated."""
    from ...core.dfl_dds import FederationState

    return FederationState(params=ROW, opt_state=ROW, state_matrix=REPLICATED,
                           epoch=REPLICATED)


_ALGORITHMS: dict[str, Algorithm] = {}


def register_algorithm(cls: type[Algorithm]) -> type[Algorithm]:
    """Class decorator: instantiate and register under ``cls.name``."""
    _ALGORITHMS[cls.name] = cls()
    return cls


def get_algorithm(name: str) -> Algorithm:
    try:
        return _ALGORITHMS[name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r} "
            f"(registered: {'|'.join(available_algorithms())})") from None


def available_algorithms() -> list[str]:
    return sorted(_ALGORITHMS)


def algorithm_registry() -> dict[str, Algorithm]:
    """Snapshot of the registry (name -> instance), for the docs tables."""
    return dict(_ALGORITHMS)
