"""Data partitioners (paper Sec. VI-A.4).

* balanced & non-IID: label-sorted shard assignment — samples are grouped by
  label, split into ``shards_per_vehicle * K`` shards, each vehicle draws
  ``shards_per_vehicle`` shards (paper: 4 shards -> 2..4 labels/vehicle,
  equal sample counts).
* unbalanced & IID: uniform random samples, per-vehicle counts drawn from a
  small set (paper: {125, 375, 1125} CIFAR-10 / {150, 450, 1350} MNIST).
"""
from __future__ import annotations

import numpy as np


def balanced_noniid(labels: np.ndarray, num_vehicles: int,
                    shards_per_vehicle: int = 4, seed: int = 0) -> list[np.ndarray]:
    """Return per-vehicle index arrays (equal sizes, few labels each)."""
    rng = np.random.default_rng(seed)
    order = np.argsort(labels, kind="stable")
    num_shards = num_vehicles * shards_per_vehicle
    usable = (len(order) // num_shards) * num_shards
    shards = np.split(order[:usable], num_shards)
    perm = rng.permutation(num_shards)
    out = []
    for k in range(num_vehicles):
        take = perm[k * shards_per_vehicle:(k + 1) * shards_per_vehicle]
        out.append(np.concatenate([shards[s] for s in take]))
    return out


def unbalanced_iid(num_samples: int, num_vehicles: int,
                   size_choices: tuple[int, ...] = (125, 375, 1125),
                   seed: int = 0) -> list[np.ndarray]:
    """Per-vehicle IID index arrays with heterogeneous sizes.

    Sizes are drawn from ``size_choices``; indices are sampled without
    replacement when possible (falls back to with-replacement if the draw
    exceeds the dataset).
    """
    rng = np.random.default_rng(seed)
    sizes = rng.choice(size_choices, size=num_vehicles)
    total = int(np.sum(sizes))
    if total <= num_samples:
        pool = rng.permutation(num_samples)[:total]
    else:
        pool = rng.integers(0, num_samples, size=total)
    out, offset = [], 0
    for s in sizes:
        out.append(np.sort(pool[offset:offset + int(s)]))
        offset += int(s)
    return out


def pad_to_uniform(indices: list[np.ndarray], seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Stack ragged per-vehicle index lists into a dense [K, max_n] array.

    Short rows are padded by *resampling their own indices* (so batches drawn
    from padded rows keep the vehicle's data distribution); returns the dense
    array plus the true per-vehicle sample counts [K].
    """
    rng = np.random.default_rng(seed)
    counts = np.array([len(ix) for ix in indices])
    width = int(counts.max())
    dense = np.zeros((len(indices), width), dtype=np.int64)
    for k, ix in enumerate(indices):
        if len(ix) == width:
            dense[k] = ix
        else:
            extra = rng.choice(ix, size=width - len(ix), replace=True)
            dense[k] = np.concatenate([ix, extra])
    return dense, counts


def label_histogram(labels: np.ndarray, indices: list[np.ndarray], num_classes: int) -> np.ndarray:
    """[K, num_classes] per-vehicle label histograms (for diagnostics)."""
    return np.stack([np.bincount(labels[ix], minlength=num_classes) for ix in indices])
