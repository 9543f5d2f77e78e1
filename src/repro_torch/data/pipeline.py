"""Batching pipeline for federated training.

Everything stays on the run's device: the full train set lives as one tensor;
each global epoch the pipeline draws per-vehicle (E local steps x B) sample
indices from the vehicle's partition (dense [K, W] index table with true
counts, see partition.pad_to_uniform) and gathers there.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor


class FederatedData(NamedTuple):
    x: Tensor            # [N, ...] full train inputs (device)
    y: Tensor            # [N] labels (int64)
    index_table: Tensor  # [K, W] per-vehicle sample indices (padded, resampled)
    counts: Tensor       # [K] true per-vehicle sample counts


def make_federated_data(train_x: np.ndarray, train_y: np.ndarray,
                        dense_indices: np.ndarray, counts: np.ndarray,
                        device="cpu") -> FederatedData:
    return FederatedData(
        x=torch.as_tensor(train_x, device=device),
        y=torch.as_tensor(train_y, device=device).long(),
        index_table=torch.as_tensor(dense_indices, device=device).long(),
        counts=torch.as_tensor(counts, device=device),
    )


def sample_batches(data: FederatedData, generator, local_steps: int,
                   batch_size: int, picks: Tensor | None = None):
    """Draw per-vehicle minibatches: returns (x, y) of shape [K, E, B, ...].

    The ``[K, E, B]`` pick tensor (positions into each vehicle's row of the
    index table) is drawn at global K from ``generator`` — a
    ``torch.Generator`` on the data's device — unless ``picks`` injects it
    (how a test feeds two stacks the same batches).
    """
    return sample_batches_sliced(data, generator, local_steps, batch_size,
                                 picks=picks)


def sample_batches_sliced(data: FederatedData, generator, local_steps: int,
                          batch_size: int, take_rows=None,
                          picks: Tensor | None = None):
    """``sample_batches`` with an optional vehicle-row slice.

    ``take_rows`` maps a [K, ...] tensor to the caller's rows — identity
    (None) on the single-device path, this shard's row block under the
    shard_map backend. The FULL [K, E, B] pick tensor is always drawn before
    slicing, so every backend consumes the same random stream and the
    per-vehicle batches match across them; only the gather is per-shard.
    """
    k, w = data.index_table.shape
    if picks is None:
        picks = torch.randint(0, w, (k, local_steps, batch_size),
                              generator=generator, device=data.x.device)
    picks = picks.to(data.x.device).long()
    table = data.index_table
    if take_rows is not None:
        picks, table = take_rows(picks), take_rows(table)
    rows = torch.arange(table.shape[0], device=data.x.device)
    idx = table[rows[:, None, None], picks]  # [K_rows, E, B]
    return data.x[idx], data.y[idx]


def stack_federated_data(datas: list[FederatedData], seed: int = 0) -> FederatedData:
    """Stack per-seed FederatedData along a leading seed axis for
    ``run_seeds``.

    The train tensors must be shared across seeds (one dataset, many
    partitions) and are NOT stacked. Index tables may have different widths
    (unbalanced partitions); short tables are padded to the common width by
    resampling each row's own entries — the reference's numpy draw from
    ``np.random.default_rng(seed)``, so the stacked tables are equal bit for
    bit — the same distribution-preserving trick as partition
    ``pad_to_uniform``.
    """
    x, y = datas[0].x, datas[0].y
    if any(d.x.shape != x.shape or not torch.equal(d.y, y) for d in datas[1:]):
        raise ValueError("stack_federated_data requires one dataset shared "
                         "across seeds (per-seed train tensors differ)")
    width = max(int(d.index_table.shape[1]) for d in datas)
    rng = np.random.default_rng(seed)
    tables = []
    for d in datas:
        table = d.index_table.cpu().numpy()
        if table.shape[1] < width:
            picks = rng.integers(0, table.shape[1],
                                 size=(table.shape[0], width - table.shape[1]))
            table = np.concatenate(
                [table, np.take_along_axis(table, picks, axis=1)], axis=1)
        tables.append(table)
    return FederatedData(
        x=x, y=y,
        index_table=torch.as_tensor(np.stack(tables), device=x.device),
        counts=torch.stack([d.counts for d in datas]),
    )


def seed_view(data: FederatedData, s: int) -> FederatedData:
    """Seed ``s`` of a seed-stacked FederatedData (its table and counts)."""
    return FederatedData(data.x, data.y, data.index_table[s], data.counts[s])


def sample_full_batches(data: FederatedData, generator, batch_size: int,
                        picks: Tensor | None = None):
    """One batch per vehicle of ``batch_size`` samples drawn from its
    partition — used by SP's single full-set local iteration (the paper's SP
    uses all local samples; we draw ``batch_size`` >= typical partition size,
    with self-resampling padding preserving the distribution). Returns
    (x, y) of shape [K, B, ...]; ``picks`` [K, B] injects the positions."""
    return sample_full_batches_sliced(data, generator, batch_size, picks=picks)


def sample_full_batches_sliced(data: FederatedData, generator, batch_size: int,
                               take_rows=None, picks: Tensor | None = None):
    """``sample_full_batches`` with an optional vehicle-row slice (see
    ``sample_batches_sliced`` — full pick tensor first, slice after, so the
    random stream is the same under every backend)."""
    k, w = data.index_table.shape
    if picks is None:
        picks = torch.randint(0, w, (k, batch_size), generator=generator,
                              device=data.x.device)
    picks = picks.to(data.x.device).long()
    table = data.index_table
    if take_rows is not None:
        picks, table = take_rows(picks), take_rows(table)
    idx = torch.gather(table, 1, picks)
    return data.x[idx], data.y[idx]
