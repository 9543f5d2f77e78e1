"""DFL-DDS: one synchronized global iteration (Alg. 1 of the paper).

The round is expressed over *stacked* federation state (leading vehicle axis
K), the whole federation on one device:

  1. exchange models + state vectors        (implicit: stacked tensors)
  2. solve P1 -> aggregation weights alpha  (kl_solver.solve_p1_all)
  3. aggregate models  w <- W @ w           (mix_params_fn: the gossip mix)
  4. E local iterations per vehicle         (user-supplied local_train_fn)
  5. aggregate state vectors S <- W @ S     (state_vector.aggregate)
  6. local state bump + normalize           (state_vector.local_update)

``local_train_fn(params, opt_state, batches, generator) -> (params, opt,
metrics)`` performs the E local updates for ALL K vehicles at once, over the
stacked ``[K, ...]`` parameters and ``[K, E, B, ...]`` batches.

Counterpart of ``repro.core.dfl_dds``. ``shard`` selects the vehicle-axis
regime (``core.vehicle_axis``): params / opt_state / batches carry this
shard's rows while the [K, K] state and mixing matrices stay replicated, so
the same round body serves the single-device vmap backend and the shard_map
backend; every shard solves P1 for all K rows from the replicated state.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..profiling import PhaseTimer, phase
from . import aggregation, kl_solver, state_vector
from .vehicle_axis import GLOBAL, VehicleSharding

Tensor = torch.Tensor


def masked_update(new, old, mask: Tensor):
    """Keep ``new`` where ``mask`` (a [K] row mask — [S, K] with a seed axis
    — broadcast over trailing dims) is positive, ``old`` elsewhere — how RSU
    rows skip local training. ``new`` / ``old`` are tensors, dictionaries or
    (named) tuples of them."""
    if isinstance(new, dict):
        return {name: masked_update(new[name], old[name], mask) for name in new}
    if isinstance(new, tuple):
        rows = [masked_update(n, o, mask) for n, o in zip(new, old)]
        return type(new)(*rows) if hasattr(new, "_fields") else tuple(rows)
    rows = mask.reshape(tuple(mask.shape) + (1,) * (new.dim() - mask.dim()))
    return torch.where(rows > 0, new, old)


class FederationState(NamedTuple):
    params: dict          # stacked [K, ...]
    opt_state: tuple      # stacked [K, ...]
    state_matrix: Tensor  # [K, K] state vectors (row k = s_k)
    epoch: Tensor         # scalar int32


def init_federation(params_stack: dict, opt_state_stack, num_vehicles: int) -> FederationState:
    device = next(iter(params_stack.values())).device
    return FederationState(
        params=params_stack,
        opt_state=opt_state_stack,
        state_matrix=state_vector.init_state(num_vehicles, device=device),
        epoch=torch.zeros((), dtype=torch.int32, device=device),
    )


def dds_round(
    fed: FederationState,
    contact_matrix,
    target: Tensor,
    batches,
    generator,
    local_train_fn: Callable,
    *,
    lr: float,
    local_steps: int,
    p1_steps: int = 200,
    p1_step_size: float = 0.5,
    mix_params_fn: Callable = aggregation.mix_params,
    local_mask: Tensor | None = None,
    timer: PhaseTimer | None = None,
    shard: VehicleSharding = GLOBAL,
) -> tuple[FederationState, dict]:
    """One DFL-DDS global iteration for the whole federation.

    ``contact_matrix`` is the epoch's dense ``[K, K]`` matrix or its
    ``SparseContacts`` neighbour list. ``local_mask`` [K] marks participants
    that run local iterations; RSUs (paper Sec. V-C — static, data-less
    relays) carry 0 and only mix. ``generator`` feeds the local training's
    dropout (None: no dropout); its masks are drawn at global K and then
    row-sliced, so the per-vehicle streams are the same in both regimes.
    """
    # -- steps 1-2: alpha from P1 on the exchanged state vectors ------------
    with phase(timer, "p1_solve"):
        mixing = kl_solver.solve_p1_all(
            fed.state_matrix, target, contact_matrix,
            num_steps=p1_steps, step_size=p1_step_size,
        )
        mixing = aggregation.mixing_from_alpha(mixing, contact_matrix)

    # -- step 3: aggregate models -------------------------------------------
    with phase(timer, "mix"):
        params = mix_params_fn(mixing, fed.params)

    # -- step 4: E local iterations per vehicle -----------------------------
    with phase(timer, "local_train"):
        new_params, opt_state, metrics = local_train_fn(
            params, fed.opt_state, batches, shard.local_generator(generator))
        if local_mask is not None:
            row_mask = shard.local_rows(local_mask)
            params = masked_update(new_params, params, row_mask)
            opt_state = masked_update(opt_state, fed.opt_state, row_mask)
        else:
            params = new_params

    # -- steps 5-6: state-vector aggregation + local bump -------------------
    with phase(timer, "state_update"):
        state = state_vector.aggregate(fed.state_matrix, mixing)
        state = state_vector.local_update(state, lr, local_steps,
                                          update_mask=local_mask)
        out = FederationState(params, opt_state, state, fed.epoch + 1)
        diags = {
            "kl_divergence": state_vector.kl_to_target(state, target),
            "entropy": state_vector.entropy(state),
            "mixing": mixing,
            **metrics,
        }
    return out, diags
