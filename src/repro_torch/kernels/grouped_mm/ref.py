"""Plain PyTorch grouped products: the counterpart of ``jax.lax.ragged_dot``
(rows ``offsets[e]:offsets[e+1]`` of ``x`` times ``w[e]``; rows in no group
give 0) and of its weight gradient. A loop of per-group ``torch.matmul``s in
f32, cast back to the inputs' dtype. It reads the group bounds on the host,
so it runs on the CPU (and in tests) only.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _bounds(offsets: Tensor, m: int) -> list[int]:
    return [min(max(int(o), 0), m) for o in offsets.tolist()]


def grouped_mm_ref(x: Tensor, w: Tensor, offsets: Tensor, trans_w: bool = False) -> Tensor:
    """x [M, K]; w [E, K, N] (or [E, N, K] with ``trans_w``); offsets [E + 1].
    Returns [M, N] in x.dtype."""
    m = x.shape[0]
    n = w.shape[1] if trans_w else w.shape[2]
    bounds = _bounds(offsets, m)
    pieces = [x.new_zeros((bounds[0], n))]
    for e in range(w.shape[0]):
        lo, hi = bounds[e], max(bounds[e + 1], bounds[e])
        we = w[e].float()
        pieces.append((x[lo:hi].float() @ (we.T if trans_w else we)).to(x.dtype))
    pieces.append(x.new_zeros((m - max(bounds[-1], bounds[0]), n)))
    return torch.cat(pieces)


def grouped_mm_wgrad_ref(x: Tensor, dy: Tensor, offsets: Tensor) -> Tensor:
    """x [M, K]; dy [M, N]; offsets [E + 1]. Returns dw [E, K, N] in x.dtype,
    ``dw[e] = x[rows of e]^T @ dy[rows of e]`` (0 for an empty group)."""
    bounds = _bounds(offsets, x.shape[0])
    return torch.stack([
        (x[lo:max(hi, lo)].float().T @ dy[lo:max(hi, lo)].float()).to(x.dtype)
        for lo, hi in zip(bounds[:-1], bounds[1:])])
