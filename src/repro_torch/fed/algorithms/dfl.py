"""DFL (decentralized FedAvg, paper baseline [6]) as a registered Algorithm."""
from __future__ import annotations

import torch

from ...core import baselines, dfl_dds
from .base import Algorithm, AlgorithmSetup, federation_state_spec, register_algorithm


@register_algorithm
class DFL(Algorithm):
    """Decentralized FedAvg [6]: sample-size-proportional gossip weights.

    Aggregate-then-train (core.baselines.dfl_round); sample counts are read
    from the round's ``fed_data`` argument."""

    name = "dfl"

    def init_state(self, setup: AlgorithmSetup):
        return dfl_dds.init_federation(setup.params_stack, setup.opt_stack,
                                       setup.total_nodes)

    def round(self, setup, state, contacts_t, target, batch, generator, fed_data):
        cfg = setup.cfg
        return baselines.dfl_round(
            state, contacts_t, target, batch, generator, setup.local_train_fn,
            sample_counts=fed_data.counts.to(torch.float32), lr=cfg.lr,
            local_steps=cfg.local_steps, mix_params_fn=setup.mix_params_fn,
            local_mask=setup.local_mask,
            shard=setup.shard)

    def model_of(self, setup, state):
        return state.params

    def state_spec(self, setup):
        return federation_state_spec(setup)
