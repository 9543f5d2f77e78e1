"""SP (subgradient-push, paper baseline [5]) as a registered Algorithm."""
from __future__ import annotations

import torch

from ...core import baselines
from ...core.vehicle_axis import REPLICATED, ROW
from ...data import pipeline
from .base import Algorithm, AlgorithmSetup, register_algorithm

# upper bound on the materialized "full local set" batch (see SP.sample)
FULL_BATCH_CAP = 256


def make_grad_fn(loss_fn):
    """Full-batch subgradients of the whole stack: ``loss_fn`` gives the
    ``[K]`` per-vehicle losses of a stacked forward, and vehicle k's weights
    enter only loss k, so one backward pass of their sum yields every
    vehicle's own gradient."""

    def grad_fn(params, batch, generator):
        x, y = batch
        with torch.enable_grad():
            leaves = {name: p.detach().requires_grad_(True)
                      for name, p in params.items()}
            loss = loss_fn(leaves, x, y, generator)
            grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
        return dict(zip(leaves, grads)), {"loss": loss.detach()}

    return grad_fn


@register_algorithm
class SP(Algorithm):
    """Subgradient-push [5]: push-sum gossip + one full-set step per epoch.

    core.baselines.sp_round; evaluation de-biases by the push-sum weights
    (z = x / y)."""

    name = "sp"

    def init_state(self, setup: AlgorithmSetup):
        return baselines.init_push_sum(setup.params_stack, setup.total_nodes)

    def round(self, setup, state, contacts_t, target, batch, generator, fed_data):
        return baselines.sp_round(state, contacts_t, target, batch, generator,
                                  grad_fn=make_grad_fn(setup.loss_fn),
                                  lr=setup.cfg.lr,
                                  mix_params_fn=setup.mix_params_fn,
                                  shard=setup.shard)

    def sample(self, setup, fed_data, generator):
        # SP uses the full local dataset per iteration (paper Sec. VI-A.5);
        # the materialized batch is capped at FULL_BATCH_CAP
        # resampled-from-own-partition samples — an unbiased full-batch
        # estimate, as in the reference
        full_bs = min(int(fed_data.index_table.shape[-1]), FULL_BATCH_CAP)
        if setup.shard.is_sharded:
            return pipeline.sample_full_batches_sliced(
                fed_data, generator, full_bs, take_rows=setup.shard.local_rows)
        return pipeline.sample_full_batches(fed_data, generator, full_bs)

    def model_of(self, setup, state):
        return baselines.sp_model(state, shard=setup.shard)

    def state_spec(self, setup):
        # [K] push-sum weights: tiny, replicated
        return baselines.PushSumState(x=ROW, y=REPLICATED, state_matrix=REPLICATED,
                                      epoch=REPLICATED)
