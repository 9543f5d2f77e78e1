"""Model aggregation for decentralized FL: mixing matrices and the gossip mix.

One synchronized round of decentralized aggregation (Eq. 10 executed on every
vehicle) is, in stacked form,

    w_{t+1} = W_t @ w_t

with ``W_t`` the ``[K, K]`` row-stochastic matrix of aggregation weights
(supported on the time-t contact graph).

``mix_params`` applies W to a dictionary of tensors whose leaves carry a
leading vehicle axis. It is the plain-torch path (``mixing_backend="torch"``);
the hand-written CUDA kernels of ``repro_torch.kernels.gossip_mix`` serve the
same function behind ``mixing_backend="cuda"``.

Every mixing constructor (and ``mix_params``) dispatches on the contact
representation: a dense ``[K, K]`` matrix yields a dense row-stochastic W,
a ``contacts.SparseContacts`` neighbour list yields a ``SparseMixing`` with
the same weights on the same edges (see core/contacts.py).

Each function also takes a leading seed axis (``run_seeds``): ``[S, K, K]``
dense matrices, ``[S, K, D]`` neighbour lists, ``[S, K, ...]`` leaves and
``[S, K]`` per-vehicle vectors; every seed's rows go through the operations
a single run's do.
"""
from __future__ import annotations

import torch

from .contacts import (SparseContacts, SparseMixing, self_slots,
                       sparse_mix_array, take_ids)

Tensor = torch.Tensor


def _renormalize(idx: Tensor, w: Tensor) -> SparseMixing:
    return SparseMixing(
        idx, w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12))


def mixing_from_alpha(alpha: Tensor, contacts) -> Tensor | SparseMixing:
    """Mask + renormalize alpha rows onto the contact set -> row-stochastic W.

    Dense: ``alpha`` [K, K] against the 0/1 contact matrix. Sparse: ``alpha``
    [K, D] per-slot weights against a ``SparseContacts`` of the same layout.
    """
    if isinstance(contacts, SparseContacts):
        return _renormalize(contacts.idx, alpha * contacts.mask)
    w = alpha * contacts
    return w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)


def uniform_mixing(contacts) -> Tensor | SparseMixing:
    """W[k, k'] = 1/|P_k| on the contact set (incl. self)."""
    if isinstance(contacts, SparseContacts):
        return _renormalize(contacts.idx, contacts.mask.to(torch.float32))
    c = contacts.to(torch.float32)
    return c / torch.clamp(torch.sum(c, dim=-1, keepdim=True), min=1e-12)


def metropolis_mixing(contacts) -> Tensor | SparseMixing:
    """Metropolis-Hastings weights: symmetric, doubly stochastic on undirected
    graphs — a classic gossip baseline (beyond-paper reference point)."""
    if isinstance(contacts, SparseContacts):
        m = contacts.mask.to(torch.float32)
        deg = torch.sum(m, dim=-1) - 1.0                   # exclude self
        deg_nbr = take_ids(deg, contacts.idx)              # [K, D] gather
        sel = self_slots(contacts)
        off = m * (1.0 - sel) / (1.0 + torch.maximum(deg.unsqueeze(-1), deg_nbr))
        diag = 1.0 - torch.sum(off, dim=-1)
        return SparseMixing(contacts.idx, off + sel * diag.unsqueeze(-1))
    c = contacts.to(torch.float32)
    deg = torch.sum(c, dim=-1) - 1.0  # exclude self
    off = c * (1.0 / (1.0 + torch.maximum(deg.unsqueeze(-1), deg.unsqueeze(-2))))
    off = off * (1.0 - torch.eye(c.shape[-1], device=c.device))
    diag = 1.0 - torch.sum(off, dim=-1)
    return off + torch.diag_embed(diag)


def sample_size_mixing(contacts, sample_counts: Tensor) -> Tensor | SparseMixing:
    """Decentralized-FedAvg weights [6]: proportional to neighbour sample counts."""
    counts = torch.as_tensor(sample_counts).to(torch.float32)
    if isinstance(contacts, SparseContacts):
        return _renormalize(contacts.idx,
                            contacts.mask * take_ids(counts, contacts.idx))
    c = contacts.to(torch.float32)
    w = c * counts.unsqueeze(-2)
    return w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)


def mix_params(mixing, params: dict) -> dict:
    """Apply the gossip mix to a dictionary of ``[K, ...]`` tensors.

    A ``SparseMixing`` routes through the gather + slot-loop segment sum
    (``contacts.sparse_mix_array``); a dense W through a full-f32 matrix
    product over the vehicle axis (the default f32 matmul precision of
    PyTorch is full f32, not TF32). Mixing is f32, cast back to the leaf
    dtype. A ``[S, K, K]`` W mixes ``[S, K, ...]`` leaves seed by seed.
    """
    if isinstance(mixing, SparseMixing):
        return {name: sparse_mix_array(mixing, x) for name, x in params.items()}

    w = mixing.to(torch.float32)
    lead = w.dim() - 1          # the vehicle axis, after any seed axis

    def mix_leaf(x: Tensor) -> Tensor:
        flat = x.reshape(tuple(x.shape[:lead]) + (-1,)).to(torch.float32)
        mixed = (w @ flat).reshape(tuple(w.shape[:-1]) + tuple(x.shape[lead:]))
        return mixed.to(x.dtype)

    return {name: mix_leaf(x) for name, x in params.items()}


def mix_params_lowp(mixing: Tensor, params: dict) -> dict:
    """Gossip mix with a bfloat16 exchange payload (the ``gossip_bf16``
    variant): W and every leaf are rounded to bf16, the products accumulate
    in f32 and the result is f32, cast back to the leaf's dtype. A torch bf16
    matmul would round its result to bf16 as well; instead the rounded
    operands are multiplied in f32, where products of bf16 values are exact,
    so this equals the reference's ``preferred_element_type=f32`` product up
    to the order of the sums. Dense W only, as in the reference."""
    w = mixing.to(torch.bfloat16).to(torch.float32)

    def mix_leaf(x: Tensor) -> Tensor:
        flat = x.reshape(x.shape[0], -1).to(torch.bfloat16).to(torch.float32)
        return (w @ flat).reshape((w.shape[0],) + tuple(x.shape[1:])).to(x.dtype)

    return {name: mix_leaf(x) for name, x in params.items()}


def consensus_distance(params: dict, seed_axis: bool = False, shard=None) -> Tensor:
    """Xi_t^2 = (1/K) sum_k || w_bar - w_k ||^2 over a stacked dictionary;
    ``seed_axis`` gives one distance per seed of ``[S, K, ...]`` leaves ->
    ``[S]``.

    With a sharded ``shard`` (``core.vehicle_axis.VehicleSharding``), the
    leading axis of every leaf is this shard's row block of a federation
    sharded over its group (shard_map backend): the global mean and the
    squared deviations are completed by all-reduces over the group. The
    global path is unchanged.
    """
    if seed_axis:
        seeds = next(iter(params.values())).shape[0]
        return torch.stack([
            consensus_distance({name: leaf[s] for name, leaf in params.items()})
            for s in range(seeds)])
    leaves = list(params.values())
    k = leaves[0].shape[0]
    if shard is None or not shard.is_sharded:
        total = 0.0
        for leaf in leaves:
            flat = leaf.reshape(k, -1).to(torch.float32)
            mean = torch.mean(flat, dim=0, keepdim=True)
            total = total + torch.sum((flat - mean) ** 2)
        return total / k

    k_global = k * shard.num_shards
    flats = [leaf.reshape(k, -1).to(torch.float32) for leaf in leaves]
    # every leaf's column sums in one all-reduce (the sum is elementwise)
    sums = shard.psum(torch.cat([torch.sum(flat, dim=0) for flat in flats]))
    total = 0.0
    for flat, col_sum in zip(flats, sums.split([f.shape[1] for f in flats])):
        total = total + torch.sum((flat - col_sum / k_global) ** 2)
    return shard.psum(total) / k_global
