"""Carrying weights and federation state between the JAX package and the port.

The port keeps the reference's parameter names and layouts (NHWC inputs, HWIO
conv weights, ``[in, out]`` dense weights), so conversion is a change of
container only: numpy arrays in, tensors on a device out, and back. Callers
export from JAX with ``np.asarray`` on each leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.dfl_dds import FederationState
from .optim import AdamState, ScaleState


def params_from_numpy(params: dict, device="cpu") -> dict:
    """Single (``[...]``) or stacked (``[K, ...]``) CNN parameters, as the
    reference holds them, to a dictionary of tensors on ``device``. Values
    may be numpy arrays or tensors; names, shapes and dtypes are kept."""
    return {name: (p.detach() if isinstance(p, torch.Tensor)
                   else torch.tensor(np.asarray(p))).to(device)
            for name, p in params.items()}


def transformer_params_from_numpy(params: dict, device="cpu") -> dict:
    """A transformer's parameters as the reference holds them — ``embed``,
    ``blocks`` (stacked ``[L, ...]`` ``attn`` / ``mlp`` / norm leaves),
    ``final_norm``, ``lm_head`` — as numpy arrays (or tensors) to the same
    nested dictionary of tensors on ``device``, each a copy. Layouts, shapes
    and dtypes are kept; ``to_numpy`` takes the tree back."""
    if isinstance(params, dict):
        return {name: transformer_params_from_numpy(v, device) for name, v in params.items()}
    if isinstance(params, torch.Tensor):
        return params.detach().to(device, copy=True)
    return torch.tensor(np.asarray(params), device=device)


def federation_state_from_numpy(params: dict, opt_count, state_matrix, epoch,
                                device="cpu") -> FederationState:
    """A ``FederationState`` from the reference's pieces: stacked ``params``,
    the SGD step counters (``opt_state.count``, ``[K]``), the ``[K, K]``
    ``state_matrix`` and the scalar ``epoch``."""
    return FederationState(
        params=params_from_numpy(params, device),
        opt_state=ScaleState(count=torch.as_tensor(
            np.asarray(opt_count), dtype=torch.int32, device=device)),
        state_matrix=torch.as_tensor(
            np.asarray(state_matrix), dtype=torch.float32, device=device),
        epoch=torch.as_tensor(np.asarray(epoch), dtype=torch.int32,
                              device=device),
    )


def train_state_from_numpy(params: dict, opt_state, state_matrix,
                           device="cpu") -> tuple[dict, AdamState, torch.Tensor]:
    """The transformer federation state of ``repro.launch.steps`` to the
    port's: the stacked ``[V, ...]`` parameter tree, the AdamW state (any
    object with ``count`` ``[V]`` int32, ``mu`` and ``nu`` trees, such as the
    reference's ``AdamState``) and the ``[V, V]`` state matrix, on ``device``.
    Every tensor is a copy (the train step updates its state in place);
    ``to_numpy`` takes the three back."""
    return (transformer_params_from_numpy(params, device),
            AdamState(count=torch.tensor(np.asarray(opt_state.count), dtype=torch.int32,
                                         device=device),
                      mu=transformer_params_from_numpy(opt_state.mu, device),
                      nu=transformer_params_from_numpy(opt_state.nu, device)),
            torch.tensor(np.asarray(state_matrix), dtype=torch.float32, device=device))


def place_train_state(state: tuple, mesh, specs: tuple, *, local_rows: bool = False) -> tuple:
    """A stacked ``(params, opt_state, state_matrix)`` — the reference's
    layout, as ``train_state_from_numpy`` returns it or as numpy arrays — on
    a federation mesh, for ``launch.steps``'s round on it: each leaf a
    DTensor placed by its spec (``specs``: the step's ``in_specs``, whose
    first three entries are these), this rank holding its own vehicle rows
    and its shard of them over ``fsdp`` / ``model``. Nothing is
    communicated.

    A tensor leaf holds the global values on every rank and is cut as a view
    (on a mesh of one rank each local tensor is the leaf itself). A numpy
    leaf is cut on the host and only this rank's block is copied to the
    mesh's device (a card under NCCL), so the global stack never reaches
    it. With ``local_rows`` every leaf (the counters and the state
    matrix too) holds only this rank's vehicle rows (``vehicle_rows`` of
    the stack: drawn or loaded by each rank for itself), so that no rank
    holds the global stack at all; only the ``fsdp`` / ``model`` dims are
    cut."""
    from .launch.mesh import vehicle_axes
    from .launch.sharding import place_tree

    local_axes = vehicle_axes(mesh) if local_rows else ()
    return tuple(place_tree(x, mesh, spec, local_axes=local_axes)
                 for x, spec in zip(state, specs[:3]))


def vehicle_rows(mesh, num_vehicles: int) -> slice:
    """This rank's rows of a stacked ``[V, ...]`` leaf on a federation mesh:
    the block of its place along the vehicle axes (pod major), as
    ``place_train_state`` cuts them."""
    from .launch.mesh import vehicle_axes

    index, shards = 0, 1
    for name in vehicle_axes(mesh):
        size = mesh.size(mesh.mesh_dim_names.index(name))
        index = index * size + mesh.get_local_rank(name)
        shards *= size
    per = num_vehicles // shards
    return slice(index * per, (index + 1) * per)


def to_numpy(tree):
    """Tensors -> numpy arrays through dictionaries and (named) tuples —
    parameters, optimizer state or a whole ``FederationState``."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {name: to_numpy(v) for name, v in tree.items()}
    if isinstance(tree, tuple):
        items = [to_numpy(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree
