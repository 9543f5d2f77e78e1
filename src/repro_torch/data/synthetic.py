"""Procedural stand-ins for MNIST / CIFAR-10.

The repository does not bundle the real datasets. These generators
produce datasets with the *same tensor shapes, sizes and class structure*
(60k/10k 1x28x28 10-class; 50k/10k 3x32x32 10-class) from per-class smooth
prototypes + per-sample geometric and photometric noise, so every experiment
in the paper runs unchanged and class-skew (non-IID) phenomena behave the
same way. Real files are used instead when available (see datasets.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Dataset:
    train_x: np.ndarray  # [N, H, W, C] float32 in [0, 1]
    train_y: np.ndarray  # [N] int32
    test_x: np.ndarray
    test_y: np.ndarray
    num_classes: int
    name: str


def _smooth_prototypes(rng: np.ndarray, num_classes: int, h: int, w: int, c: int,
                       base: int = 7) -> np.ndarray:
    """Per-class smooth random patterns: low-res gaussian grids, bilinearly
    upsampled — distinct, smooth, overlapping class manifolds."""
    lo = rng.normal(0, 1, size=(num_classes, base, base, c))
    ys = np.linspace(0, base - 1, h)
    xs = np.linspace(0, base - 1, w)
    y0 = np.floor(ys).astype(int); y1 = np.minimum(y0 + 1, base - 1); wy = (ys - y0)[None, :, None, None]
    x0 = np.floor(xs).astype(int); x1 = np.minimum(x0 + 1, base - 1); wx = (xs - x0)[None, None, :, None]
    up = (lo[:, y0][:, :, x0] * (1 - wy) * (1 - wx) + lo[:, y0][:, :, x1] * (1 - wy) * wx
          + lo[:, y1][:, :, x0] * wy * (1 - wx) + lo[:, y1][:, :, x1] * wy * wx)
    return up.astype(np.float32)


def _render(rng, protos: np.ndarray, labels: np.ndarray,
            shift: int = 3, noise: float = 0.35, contrast: float = 0.25) -> np.ndarray:
    """Sample images: shifted prototype + contrast jitter + gaussian noise."""
    n = len(labels)
    _, h, w, c = protos.shape
    out = np.empty((n, h, w, c), dtype=np.float32)
    dy = rng.integers(-shift, shift + 1, size=n)
    dx = rng.integers(-shift, shift + 1, size=n)
    gain = 1.0 + contrast * rng.normal(0, 1, size=(n, 1, 1, 1)).astype(np.float32)
    for i in range(n):
        out[i] = np.roll(protos[labels[i]], (dy[i], dx[i]), axis=(0, 1))
    out = out * gain + noise * rng.normal(0, 1, size=out.shape).astype(np.float32)
    # squash to [0, 1]
    return (1.0 / (1.0 + np.exp(-out))).astype(np.float32)


def synthetic_mnist(seed: int = 0, n_train: int = 60_000, n_test: int = 10_000) -> Dataset:
    rng = np.random.default_rng(seed)
    protos = _smooth_prototypes(rng, 10, 28, 28, 1)
    ytr = rng.integers(0, 10, size=n_train).astype(np.int32)
    yte = rng.integers(0, 10, size=n_test).astype(np.int32)
    return Dataset(
        train_x=_render(rng, protos, ytr), train_y=ytr,
        test_x=_render(rng, protos, yte), test_y=yte,
        num_classes=10, name="synthetic-mnist",
    )


def synthetic_cifar10(seed: int = 1, n_train: int = 50_000, n_test: int = 10_000) -> Dataset:
    rng = np.random.default_rng(seed)
    protos = _smooth_prototypes(rng, 10, 32, 32, 3, base=6)
    ytr = rng.integers(0, 10, size=n_train).astype(np.int32)
    yte = rng.integers(0, 10, size=n_test).astype(np.int32)
    # harder than mnist: more noise, stronger contrast jitter
    return Dataset(
        train_x=_render(rng, protos, ytr, shift=4, noise=0.6, contrast=0.4), train_y=ytr,
        test_x=_render(rng, protos, yte, shift=4, noise=0.6, contrast=0.4), test_y=yte,
        num_classes=10, name="synthetic-cifar10",
    )
