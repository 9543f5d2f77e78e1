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
