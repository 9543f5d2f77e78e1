"""Minimal functional optimizer library on torch tensors.

API mirrors ``repro.optim.optimizers`` (init_fn, update_fn):

    opt = sgd(0.1)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Parameters, gradients and updates are flat dictionaries of tensors.
``init(params, num_stacked=K)`` gives a ``[K]`` step counter for a stacked
federation (``[K, ...]`` leaves: what a vmapped ``init`` gives in the
reference); a per-step value (the learning rate of a schedule, Adam's bias
corrections) then has one entry per row and broadcasts over each leaf's
trailing axes. Every update is elementwise, so it may also be called on one
leaf at a time (a one-entry dictionary) with the same state counter.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

Tensor = torch.Tensor
Schedule = Callable[[Tensor], Tensor]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    # the settings it was built with, for a fused update to read (``adamw``:
    # ``lr``, ``b1``, ``b2``, ``eps``, ``weight_decay``); None for the others
    hyper: dict | None = None


class ScaleState(NamedTuple):
    count: Tensor   # int32 step counter: a scalar, or [K] for a stacked federation


class MomentumState(NamedTuple):
    count: Tensor
    momentum: dict


class AdamState(NamedTuple):
    count: Tensor
    mu: dict
    nu: dict


def _resolve_lr(lr, count):
    return lr(count) if callable(lr) else lr


def _count(params: dict, num_stacked: int | None) -> Tensor:
    device = next(iter(params.values())).device
    shape = () if num_stacked is None else (num_stacked,)
    return torch.zeros(shape, dtype=torch.int32, device=device)


def _zeros_like(params: dict) -> dict:
    return {name: torch.zeros_like(p, dtype=torch.float32) for name, p in params.items()}


def _per_row(value, leaf: Tensor):
    """A per-step value (a number, a scalar or a ``[K]`` tensor) shaped to
    broadcast over ``leaf``: a ``[K]`` entry per leading row."""
    if not isinstance(value, Tensor) or value.dim() == 0:
        return value
    return value.reshape(tuple(value.shape) + (1,) * (leaf.dim() - value.dim()))


def sgd(lr: float | Schedule) -> Optimizer:
    def init(params: dict, num_stacked: int | None = None) -> ScaleState:
        """``num_stacked=K`` gives one counter per vehicle of a ``[K, ...]``
        parameter stack (what a vmapped ``init`` gives in the reference)."""
        return ScaleState(count=_count(params, num_stacked))

    def update(grads: dict, state: ScaleState, params=None):
        step = _resolve_lr(lr, state.count)
        updates = {name: -_per_row(step, g) * g.to(torch.float32) for name, g in grads.items()}
        return updates, ScaleState(count=state.count + 1)

    return Optimizer(init, update)


def momentum(lr: float | Schedule, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params: dict, num_stacked: int | None = None) -> MomentumState:
        return MomentumState(count=_count(params, num_stacked), momentum=_zeros_like(params))

    def update(grads: dict, state: MomentumState, params=None):
        step = _resolve_lr(lr, state.count)
        new_m = {name: beta * state.momentum[name] + g.to(torch.float32)
                 for name, g in grads.items()}
        if nesterov:
            upd = {name: -_per_row(step, g) * (beta * new_m[name] + g.to(torch.float32))
                   for name, g in grads.items()}
        else:
            upd = {name: -_per_row(step, m) * m for name, m in new_m.items()}
        return upd, MomentumState(count=state.count + 1, momentum=new_m)

    return Optimizer(init, update)


def adamw(lr: float | Schedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params: dict, num_stacked: int | None = None) -> AdamState:
        return AdamState(count=_count(params, num_stacked), mu=_zeros_like(params),
                         nu=_zeros_like(params))

    def update(grads: dict, state: AdamState, params: dict):
        count = state.count + 1
        step = _resolve_lr(lr, state.count)
        mu = {name: b1 * state.mu[name] + (1 - b1) * g.to(torch.float32)
              for name, g in grads.items()}
        nu = {name: b2 * state.nu[name] + (1 - b2) * torch.square(g.to(torch.float32))
              for name, g in grads.items()}
        c1, c2 = adam_bias_corrections(count, b1, b2)

        def upd(name):
            m, v, p = mu[name], nu[name], params[name]
            adam = (m / _per_row(c1, m)) / (torch.sqrt(v / _per_row(c2, v)) + eps)
            return -_per_row(step, m) * (adam + weight_decay * p.to(torch.float32))

        return {name: upd(name) for name in grads}, AdamState(count=count, mu=mu, nu=nu)

    return Optimizer(init, update, dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay))


def adam_bias_corrections(count: Tensor, b1: float, b2: float) -> tuple[Tensor, Tensor]:
    """Adam's bias corrections ``1 - b1^c`` and ``1 - b2^c`` at step ``count``
    (after its increment), in f32 as the reference computes them, on
    ``count``'s device. The bases are filled there (``torch.full``), so a
    CUDA counter costs no copy from the host and no wait for the device."""
    c = count.to(torch.float32)
    base = lambda b: torch.full((), b, dtype=torch.float32, device=c.device)
    return 1 - torch.pow(base(b1), c), 1 - torch.pow(base(b2), c)


def apply_updates(params: dict, updates: dict) -> dict:
    return {name: (p.to(torch.float32) + updates[name]).to(p.dtype)
            for name, p in params.items()}


def global_norm(tree: dict) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree.values()))


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {name: g * scale.to(g.dtype) for name, g in grads.items()}
