"""Minimal functional optimizer library on torch tensors.

API mirrors ``repro.optim.optimizers`` (init_fn, update_fn):

    opt = sgd(0.1)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Parameters, gradients and updates are dictionaries of tensors. Only ``sgd``
is ported so far (``momentum``, ``adamw``, ``clip_by_global_norm`` and the
schedules are still to port).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

Tensor = torch.Tensor
Schedule = Callable[[Tensor], Tensor]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


class ScaleState(NamedTuple):
    count: Tensor   # int32 step counter: a scalar, or [K] for a stacked federation


def _resolve_lr(lr, count):
    return lr(count) if callable(lr) else lr


def sgd(lr: float | Schedule) -> Optimizer:
    def init(params: dict, num_stacked: int | None = None) -> ScaleState:
        """``num_stacked=K`` gives one counter per vehicle of a ``[K, ...]``
        parameter stack (what a vmapped ``init`` gives in the reference)."""
        device = next(iter(params.values())).device
        shape = () if num_stacked is None else (num_stacked,)
        return ScaleState(count=torch.zeros(shape, dtype=torch.int32, device=device))

    def update(grads: dict, state: ScaleState, params=None):
        step = _resolve_lr(lr, state.count)
        updates = {name: -step * g.to(torch.float32) for name, g in grads.items()}
        return updates, ScaleState(count=state.count + 1)

    return Optimizer(init, update)


def apply_updates(params: dict, updates: dict) -> dict:
    return {name: (p.to(torch.float32) + updates[name]).to(p.dtype)
            for name, p in params.items()}
