"""DFL-DDS (the paper's algorithm, Alg. 1) as a registered Algorithm."""
from __future__ import annotations

from ...core import dfl_dds
from .base import Algorithm, AlgorithmSetup, federation_state_spec, register_algorithm


@register_algorithm
class DDS(Algorithm):
    """The paper's DFL-DDS: P1-solved diversity-aware aggregation weights.

    Per round: solve P1 on the exchanged state vectors -> gossip mix -> E
    local iterations -> state-vector update (core.dfl_dds.dds_round)."""

    name = "dds"

    def init_state(self, setup: AlgorithmSetup):
        return dfl_dds.init_federation(setup.params_stack, setup.opt_stack,
                                       setup.total_nodes)

    def round(self, setup, state, contacts_t, target, batch, generator, fed_data):
        cfg = setup.cfg
        # always the config's P1 step size (2.0 by default), not dds_round's own
        return dfl_dds.dds_round(
            state, contacts_t, target, batch, generator, setup.local_train_fn,
            lr=cfg.lr, local_steps=cfg.local_steps, p1_steps=cfg.p1_steps,
            p1_step_size=cfg.p1_step_size, mix_params_fn=setup.mix_params_fn,
            local_mask=setup.local_mask, timer=setup.timer,
            shard=setup.shard)

    def model_of(self, setup, state):
        return state.params

    def state_spec(self, setup):
        return federation_state_spec(setup)
