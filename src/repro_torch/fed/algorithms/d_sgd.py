"""d_sgd: decentralized gossip SGD with Metropolis-Hastings weights
(beyond-paper baseline) as a registered Algorithm."""
from __future__ import annotations

from ...core import baselines, dfl_dds
from .base import Algorithm, AlgorithmSetup, federation_state_spec, register_algorithm


@register_algorithm
class DSGD(Algorithm):
    """D-PSGD-style gossip SGD with Metropolis-Hastings consensus weights.

    Mix with the symmetric, doubly stochastic Metropolis matrix
    (aggregation.metropolis_mixing), then E local iterations
    (core.baselines.d_sgd_round)."""

    name = "d_sgd"

    def init_state(self, setup: AlgorithmSetup):
        return dfl_dds.init_federation(setup.params_stack, setup.opt_stack,
                                       setup.total_nodes)

    def round(self, setup, state, contacts_t, target, batch, generator, fed_data):
        cfg = setup.cfg
        return baselines.d_sgd_round(
            state, contacts_t, target, batch, generator, setup.local_train_fn,
            lr=cfg.lr, local_steps=cfg.local_steps,
            mix_params_fn=setup.mix_params_fn, local_mask=setup.local_mask,
            shard=setup.shard)

    def model_of(self, setup, state):
        return state.params

    def state_spec(self, setup):
        return federation_state_spec(setup)
