"""The vehicle axis and the delayed-gossip decomposition of the mix.

Counterpart of ``repro.core.vehicle_axis`` in its global (unsharded) regime:
the whole stack lives on one device, so the reference's ``shard.local_rows``
is the identity and no ``VehicleSharding`` argument is taken. What is ported:

* ``mixing_self_weight`` — ``W[k, k]`` as a ``[K]`` vector, either format;
* ``zero_self_weight`` — the neighbour-only mixing ``W - diag(W)``;
* ``delayed_gossip_mix`` — the double-buffered exchange of
  ``SimulationConfig.overlap = "delayed"``.

Every function also takes a leading seed axis (``[S, K, K]`` / ``[S, K, D]``
mixings, ``[S, K, ...]`` leaves). The sharded pieces (``VehicleSharding``,
``sharded_mix``, the communication buckets) are still to port.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import contacts as contacts_lib

Tensor = torch.Tensor

MixParamsFn = Callable[[object, dict], dict]


def mixing_self_weight(mixing) -> Tensor:
    """The weight each vehicle keeps on itself — ``W[k, k]`` as a [K] vector
    — for one epoch's mixing in either representation. Sparse padding slots
    carry the row's own id with weight 0, so summing the self-id slots reads
    exactly the real self weight."""
    if isinstance(mixing, contacts_lib.SparseMixing):
        k = mixing.idx.shape[-2]
        rows = torch.arange(k, dtype=mixing.idx.dtype,
                            device=mixing.idx.device)[:, None]
        zero = torch.zeros((), dtype=mixing.w.dtype, device=mixing.w.device)
        return torch.sum(torch.where(mixing.idx == rows, mixing.w, zero), dim=-1)
    return torch.diagonal(mixing, dim1=-2, dim2=-1)


def zero_self_weight(mixing):
    """The same mixing with every self weight removed: the neighbour-only
    part of the gossip contraction (``W - diag(W)``)."""
    if isinstance(mixing, contacts_lib.SparseMixing):
        k = mixing.idx.shape[-2]
        rows = torch.arange(k, dtype=mixing.idx.dtype,
                            device=mixing.idx.device)[:, None]
        zero = torch.zeros((), dtype=mixing.w.dtype, device=mixing.w.device)
        return contacts_lib.SparseMixing(
            mixing.idx, torch.where(mixing.idx == rows, zero, mixing.w))
    eye = torch.eye(mixing.shape[-1], dtype=mixing.dtype, device=mixing.device)
    return mixing * (1.0 - eye)


def delayed_gossip_mix(mix_fn: MixParamsFn) -> Callable:
    """Double-buffered delayed gossip (``SimulationConfig.overlap =
    "delayed"``): the exchange for round t is launched concurrently with
    round t's local training, so neighbours' contributions arrive one round
    stale while each vehicle's own contribution stays current:

        out_k = sum_{j != k} W[k, j] * stale_j  +  W[k, k] * current_k

    ``mix_fn`` is the synchronous mix, applied to the neighbour-only mixing
    ``zero_self_weight(W)`` over the stale buffer (the same gossip-mix
    kernels, on a matrix whose rows sum to less than one); the self term
    multiplies in elementwise. With no live contacts (W = I) the neighbour
    term is exactly zero and the self weight exactly one, so the degenerate
    trajectory is bit-identical to synchronous gossip."""

    def mix(mixing, params: dict, stale: dict) -> dict:
        neighbours = mix_fn(zero_self_weight(mixing), stale)
        self_w = mixing_self_weight(mixing)

        def combine(n: Tensor, c: Tensor) -> Tensor:
            d = self_w.reshape(tuple(self_w.shape) + (1,) * (c.dim() - self_w.dim()))
            return (n.to(torch.float32)
                    + d.to(torch.float32) * c.to(torch.float32)).to(c.dtype)

        return {name: combine(neighbours[name], c) for name, c in params.items()}

    return mix
