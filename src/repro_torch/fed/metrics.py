"""Evaluation metrics used by the paper's experiments (numpy only).

A copy of ``repro.fed.metrics``: Figs. 2, 3 and 9 read these."""
from __future__ import annotations

import numpy as np


def accuracy_cdf(accuracies: np.ndarray, grid: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Empirical CDF of per-vehicle accuracies (Fig. 2). Returns (x, F(x))."""
    a = np.sort(np.asarray(accuracies))
    if grid is None:
        grid = a
    f = np.searchsorted(a, grid, side="right") / len(a)
    return grid, f


def pearson(x: np.ndarray, y: np.ndarray) -> float:
    """Pearson correlation coefficient (Fig. 3: accuracy vs diversity)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    xc = x - x.mean()
    yc = y - y.mean()
    denom = np.sqrt((xc ** 2).sum() * (yc ** 2).sum())
    if denom < 1e-12:
        return 0.0
    return float((xc * yc).sum() / denom)


def epochs_to_target(avg_acc_curve: np.ndarray, target: float) -> int | None:
    """First epoch at which the average accuracy reaches ``target`` (Fig. 9).
    Returns None if never reached (the paper's red-arrow cases)."""
    hits = np.nonzero(np.asarray(avg_acc_curve) >= target)[0]
    return int(hits[0]) + 1 if len(hits) else None


def mean_std(per_seed: np.ndarray, axis: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Seed-aggregate a stacked [S, ...] metric: (mean, std) over ``axis``
    — how the campaign results store reports scalars (population std, as
    the paper's error bars)."""
    a = np.asarray(per_seed, np.float64)
    return a.mean(axis=axis), a.std(axis=axis)


def diversity_gain(kl_trace: np.ndarray) -> float:
    """Drop in mean state-vector KL-to-target over a run (first - last epoch):
    how much the algorithm diversified its data sources (positive = gain)."""
    t = np.asarray(kl_trace, np.float64)
    if t.size == 0:
        return 0.0
    return float(t[0] - t[-1])
