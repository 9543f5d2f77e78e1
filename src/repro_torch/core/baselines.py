"""Baselines the paper compares against, plus two beyond-paper references.

* ``dfl_round`` — decentralized FedAvg [6]: aggregation weights proportional
  to neighbour sample counts; E local iterations per global epoch (same loop
  structure as DFL-DDS, different mixing matrix).
* ``d_sgd_round`` — decentralized gossip SGD (D-PSGD-style): the same
  mix-then-train loop with Metropolis-Hastings weights
  (``aggregation.metropolis_mixing``) — symmetric, doubly stochastic on the
  contact graph, the classic consensus-optimization reference point.
* ``d_fedavg_round`` — train-then-aggregate decentralized FedAvg: each
  vehicle finishes its E local iterations FIRST and the sample-size-weighted
  gossip average follows (the DFedAvg ordering), vs ``dfl_round``'s
  aggregate-then-train.
* ``sp_round`` — subgradient-push (SP) [5], per the paper's implementation
  description (Sec. IV-B): each vehicle keeps (x_k, y_k), broadcasts
  x_k/p_k and y_k/p_k to every member of P_{k,t}, performs ONE local
  iteration per global epoch on z_k = x_k / y_k with the FULL local dataset.

State vectors are also tracked for the baselines (they do not influence the
baselines' aggregation — they are needed to reproduce the paper's diversity
measurements, Figs. 2-3).

Every round takes a ``shard`` (core.vehicle_axis.VehicleSharding): the big
[K, ...] stacks (params, optimizer state, batches) carry only this shard's
rows while the small [K, K] matrices stay replicated, so the same round body
runs under the vmap backend and the shard_map backend. In the global regime
every round also takes a leading seed axis (``run_seeds``; see
``core.aggregation``). Counterpart of ``repro.core.baselines``; the
reference's quirks are kept: ``d_fedavg_round`` bumps the state vectors before it
aggregates them, and ``sp_round`` bumps every row, RSUs included (it takes
no ``local_mask``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import aggregation, state_vector
from . import contacts as contacts_lib
from .dfl_dds import FederationState, masked_update
from .vehicle_axis import GLOBAL, VehicleSharding

Tensor = torch.Tensor


def _diagnostics(state: Tensor, target: Tensor) -> dict:
    return {"kl_divergence": state_vector.kl_to_target(state, target),
            "entropy": state_vector.entropy(state)}


def gossip_round(
    fed: FederationState,
    mixing,
    target: Tensor,
    batches,
    generator,
    local_train_fn: Callable,
    *,
    lr: float,
    local_steps: int,
    mix_params_fn: Callable = aggregation.mix_params,
    local_mask: Tensor | None = None,
    shard: VehicleSharding = GLOBAL,
) -> tuple[FederationState, dict]:
    """The shared mix-then-train gossip iteration, parametrized by a
    precomputed row-stochastic ``mixing`` (dense ``[K, K]`` or a
    ``SparseMixing``): aggregate models, run E local iterations per vehicle,
    mix + bump state vectors.

    ``local_mask`` [K]: participants that run local iterations (RSUs carry 0).
    """
    params = mix_params_fn(mixing, fed.params)
    new_params, opt_state, metrics = local_train_fn(
        params, fed.opt_state, batches, shard.local_generator(generator))
    if local_mask is not None:
        row_mask = shard.local_rows(local_mask)
        params = masked_update(new_params, params, row_mask)
        opt_state = masked_update(opt_state, fed.opt_state, row_mask)
    else:
        params = new_params

    state = state_vector.aggregate(fed.state_matrix, mixing)
    state = state_vector.local_update(state, lr, local_steps, update_mask=local_mask)

    out = FederationState(params, opt_state, state, fed.epoch + 1)
    return out, {**_diagnostics(state, target), "mixing": mixing, **metrics}


def dfl_round(fed: FederationState, contact_matrix, target: Tensor, batches,
              generator, local_train_fn: Callable, *, sample_counts: Tensor,
              lr: float, local_steps: int,
              mix_params_fn: Callable = aggregation.mix_params,
              local_mask: Tensor | None = None,
              shard: VehicleSharding = GLOBAL) -> tuple[FederationState, dict]:
    """Decentralized FedAvg: alpha proportional to sample population [6]."""
    mixing = aggregation.sample_size_mixing(contact_matrix, sample_counts)
    return gossip_round(fed, mixing, target, batches, generator, local_train_fn,
                        lr=lr, local_steps=local_steps,
                        mix_params_fn=mix_params_fn, local_mask=local_mask,
                        shard=shard)


def d_sgd_round(fed: FederationState, contact_matrix, target: Tensor, batches,
                generator, local_train_fn: Callable, *, lr: float,
                local_steps: int,
                mix_params_fn: Callable = aggregation.mix_params,
                local_mask: Tensor | None = None,
                shard: VehicleSharding = GLOBAL) -> tuple[FederationState, dict]:
    """Decentralized gossip SGD: Metropolis-Hastings consensus weights —
    symmetric and doubly stochastic on the undirected contact graph."""
    mixing = aggregation.metropolis_mixing(contact_matrix)
    return gossip_round(fed, mixing, target, batches, generator, local_train_fn,
                        lr=lr, local_steps=local_steps,
                        mix_params_fn=mix_params_fn, local_mask=local_mask,
                        shard=shard)


def d_fedavg_round(fed: FederationState, contact_matrix, target: Tensor, batches,
                   generator, local_train_fn: Callable, *, sample_counts: Tensor,
                   lr: float, local_steps: int,
                   mix_params_fn: Callable = aggregation.mix_params,
                   local_mask: Tensor | None = None,
                   shard: VehicleSharding = GLOBAL) -> tuple[FederationState, dict]:
    """Train-then-aggregate decentralized FedAvg: E local iterations first,
    then the sample-size-weighted gossip average — the DFedAvg ordering.

    The state vectors mirror the model order: the local bump (Eq. 5) lands
    before the aggregation (Eq. 7), since each vehicle's own contribution is
    made before its neighbours average it in.
    """
    new_params, opt_state, metrics = local_train_fn(
        fed.params, fed.opt_state, batches, shard.local_generator(generator))
    if local_mask is not None:
        row_mask = shard.local_rows(local_mask)
        new_params = masked_update(new_params, fed.params, row_mask)
        opt_state = masked_update(opt_state, fed.opt_state, row_mask)

    mixing = aggregation.sample_size_mixing(contact_matrix, sample_counts)
    params = mix_params_fn(mixing, new_params)

    state = state_vector.local_update(fed.state_matrix, lr, local_steps,
                                      update_mask=local_mask)
    state = state_vector.aggregate(state, mixing)

    out = FederationState(params, opt_state, state, fed.epoch + 1)
    return out, {**_diagnostics(state, target), "mixing": mixing, **metrics}


class PushSumState(NamedTuple):
    x: dict               # stacked [K, ...] push-sum numerators
    y: Tensor             # [K] push-sum denominators
    state_matrix: Tensor  # [K, K]
    epoch: Tensor         # scalar int32


def init_push_sum(params_stack: dict, num_vehicles: int) -> PushSumState:
    device = next(iter(params_stack.values())).device
    return PushSumState(
        x=params_stack,
        y=torch.ones((num_vehicles,), dtype=torch.float32, device=device),
        state_matrix=state_vector.init_state(num_vehicles, device=device),
        epoch=torch.zeros((), dtype=torch.int32, device=device),
    )


def push_sum_mixing(contacts) -> Tensor | contacts_lib.SparseMixing:
    """Column-stochastic mix B[k, k'] = 1/p_{k'} if k in P_{k'} (incl. self).

    With undirected contacts, membership is symmetric: k in P_{k'} iff
    C[k, k'] = 1. Each *column* k' sums to 1 (the sender splits its mass
    evenly over its out-neighbourhood) — the defining property of push-sum.
    On a ``SparseContacts`` neighbour list, p is the per-row contact count
    (same quantity by symmetry) gathered at each slot's neighbour id, so the
    gather form stays: row k sums over its own slots.
    """
    if isinstance(contacts, contacts_lib.SparseContacts):
        p = torch.sum(contacts.mask, dim=-1)  # |P_{k'}| by symmetry
        w = contacts.mask / torch.clamp(contacts_lib.take_ids(p, contacts.idx),
                                        min=1e-12)
        return contacts_lib.SparseMixing(contacts.idx, w)
    c = contacts.to(torch.float32)
    p = torch.sum(c, dim=-1)  # |P_{k'}| by symmetry
    return c / torch.clamp(p.unsqueeze(-2), min=1e-12)


def _divide_rows(params: dict, y: Tensor) -> dict:
    return {name: leaf / y.reshape(tuple(y.shape) + (1,) * (leaf.dim() - y.dim()))
            for name, leaf in params.items()}


def sp_round(
    ps: PushSumState,
    contact_matrix,
    target: Tensor,
    full_batches,
    generator,
    grad_fn: Callable,
    *,
    lr: float,
    mix_params_fn: Callable = aggregation.mix_params,
    shard: VehicleSharding = GLOBAL,
) -> tuple[PushSumState, dict]:
    """One subgradient-push global iteration.

    ``grad_fn(params, batch, generator) -> (grads, metrics)`` computes the
    full-batch subgradients at the de-biased models z = x/y for the whole
    stack (``[K, ...]`` in, ``[K, ...]`` out; ``metrics["loss"]`` is ``[K]``).

    Under a sharded vehicle axis, ``x`` carries this shard's rows; the tiny
    push-sum weight vector ``y`` [K] stays replicated (its mix is a [K, K] @
    [K] product every shard repeats).
    """
    mixing = push_sum_mixing(contact_matrix)

    # push step: x <- B x, y <- B y
    x = mix_params_fn(mixing, ps.x)
    y = contacts_lib.mix_vector(mixing, ps.y)

    # de-biased model and one subgradient step on x
    grads, metrics = grad_fn(_divide_rows(x, shard.local_rows(y)), full_batches,
                             shard.local_generator(generator))
    x = {name: xl - lr * grads[name].to(xl.dtype) for name, xl in x.items()}

    # state vectors: SP mixes with B then bumps once (one local iteration),
    # every row — the reference passes no update_mask here
    state = state_vector.aggregate(ps.state_matrix, mixing)
    state = state_vector.local_update(state, lr, 1)

    out = PushSumState(x, y, state, ps.epoch + 1)
    return out, {**_diagnostics(state, target), "push_weights": y, **metrics}


def sp_model(ps: PushSumState, shard: VehicleSharding = GLOBAL) -> dict:
    """The models SP evaluates: z_k = x_k / y_k (rows of y matching the
    shard's rows of x)."""
    return _divide_rows(ps.x, shard.local_rows(ps.y))
