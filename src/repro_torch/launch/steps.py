"""The DFL-DDS training round over a stack of vehicle transformers, and the
serving steps (prefill / decode).

Counterpart of ``repro.launch.steps``. The steps hold their function only:
the sharding specs, ``train_state_specs`` and ``named`` come with the port's
``launch/sharding.py``, and no builder takes a mesh yet.

One round (``build_dds_train_step``), for V vehicles whose parameters are
stacked on a leading ``[V]`` axis of every leaf (the layout of
``init_train_state`` and ``convert.train_state_from_numpy``):

  P1 (aggregation weights from the state vectors) -> the gossip mix of the
  whole stack -> E local AdamW steps per vehicle on its tokens -> the state
  vectors' update (Eqs. 5-7).

Memory decides its shape at full width. The default mix
(``kernels.gossip_mix.ops.mix_params_cuda_``) writes the mixed stack into the
parameter leaves themselves: no second copy of the stack and no copy back. It
does so on the card where ``gossip_mix_matmul`` mixes V x V in place (its
column mapping, ``kernel.matmul_path``: V <= 16) and always on the CPU. Past
that limit the round takes the functional ``mix_params_cuda`` (the kernel's
tile mapping), as it does a ``mix_params_fn`` passed by the caller: the output
is copied back into the leaves and freed. Each vehicle then trains on views of
its row of every leaf (detached, ``requires_grad_``, ``torch.autograd.grad``
of ``lm_loss``), and the AdamW update is applied one leaf at a time, written
in place into that row of the parameters and of the moments, each gradient
freed as soon as it is used. So the step updates ``params`` and ``opt_state``
in place, and returns them. In model copies for V vehicles (f32, one copy is
7.57 GiB at qwen3-1.7b's width): 3V at the mix (parameters V, AdamW moments
2V; 4V with a functional mix), 3V + 1 (one vehicle's gradients) plus the
loss's activations and one leaf's temporaries during local training. At V=2
that is 6 copies (45.4 GiB) at the mix and 7 (53.0 GiB) plus activations in
training, where a functional mix peaks at 8 (60.6 GiB); a whole-tree
functional AdamW update of one vehicle would hold three more copies of a
model. The loop over vehicles is the port's counterpart of the reference's
``vmap``, as the loop over layers is of its ``lax.scan``. The reference splits
an ``rng`` per vehicle and uses none of it (no dropout), so the port's step
takes none.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..configs.base import ArchConfig
from ..core import aggregation, kl_solver, state_vector
from ..kernels.gossip_mix import kernel as mix_kernel
from ..kernels.gossip_mix.ops import mix_params_cuda, mix_params_cuda_
from ..models import transformer
from ..optim import AdamState, adamw, apply_updates
from ..profiling import PhaseTimer, phase

Tensor = torch.Tensor

_SEP = "/"


def flatten(tree: dict, prefix: str = "") -> dict:
    """A nested dictionary's leaves by their ``/``-joined key path (the
    checkpoints' keys); the leaves themselves, not copies."""
    flat = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            flat.update(flatten(node, f"{prefix}{name}{_SEP}"))
        else:
            flat[f"{prefix}{name}"] = node
    return flat


def unflatten(flat: dict) -> dict:
    """``flatten``'s inverse."""
    tree: dict = {}
    for key, leaf in flat.items():
        *path, name = key.split(_SEP)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree


def _row(flat: dict, v: int) -> dict:
    """Row ``v`` of every stacked leaf (views)."""
    return {name: leaf[v] for name, leaf in flat.items()}


# ------------------------------------------------------------- training -----

@dataclass
class TrainStep:
    # (params, opt_state, state_matrix, tokens, contact, target[, prefix_embeds])
    #   -> (params, opt_state, state_matrix, metrics)
    fn: Callable


def _mixes_in_place(mixing: Tensor) -> bool:
    """Whether the default mix writes a ``[V, V]`` mixing into the stack: on
    the CPU always (the plain product), on the card where ``gossip_mix_matmul``'s
    launcher mixes V x V in place (its column mapping)."""
    v = mixing.shape[-1]
    return not mixing.is_cuda or mix_kernel.matmul_path(v, v) == mix_kernel.MATMUL_COLUMNS


def build_dds_train_step(cfg: ArchConfig, *,
                         local_steps: int = 1,
                         lr: float = 1e-4,
                         p1_steps: int = 100,
                         remat: bool = True,
                         attn_impl=None,
                         compute_dtype=None,
                         mix_params_fn=None,
                         timer: PhaseTimer | None = None) -> TrainStep:
    """One DFL-DDS global iteration over the stacked vehicle axis, for a
    transformer architecture.

    ``fn(params, opt_state, state_matrix, tokens, contact, target,
    prefix_embeds=None)``: ``params`` the nested tree of ``[V, ...]`` leaves,
    ``opt_state`` an ``AdamState`` (``count`` ``[V]`` int32, ``mu`` / ``nu``
    trees like ``params``), ``state_matrix`` ``[V, V]``, ``tokens``
    ``[V, B, S]``, ``contact`` the ``[V, V]`` 0/1 contact matrix, ``target``
    ``[V]``, ``prefix_embeds`` ``[V, B, P, d]`` for a VLM / audio
    configuration. Returns ``(params, opt_state, state_matrix, metrics)``:
    the first two updated in place, ``metrics`` ``{"loss": mean over vehicles
    and local steps, "kl": mean kl_to_target}`` (0-d tensors).

    ``mix_params_fn`` is a functional gossip mix of a flat ``{path: [V, ...]}``
    dictionary (``aggregation.mix_params``, the reference's default;
    ``aggregation.mix_params_lowp``), its output copied back into the leaves.
    Without one, the round mixes through the port's ``mixing_backend="cuda"``
    (one grouped ``gossip_mix_matmul`` launch for a model of one dtype on the
    card; the plain product for CPU leaves): in place through
    ``kernels.gossip_mix.ops.mix_params_cuda_`` where ``_mixes_in_place``,
    else through the functional ``mix_params_cuda`` and a copy back.
    ``compute_dtype`` runs the loss in that dtype on the f32 master weights
    (the cast is inside the loss, so the gradients reach the f32 leaves).
    ``timer`` brackets the round's phases (``p1_solve``, ``mix``,
    ``local_train``, ``state_update``), as the federation engine's rounds.
    """
    optimizer = adamw(lr)

    def loss_fn(leaves: dict, toks: Tensor, pre: Tensor | None) -> Tensor:
        if compute_dtype is not None:
            leaves = {name: x.to(compute_dtype) for name, x in leaves.items()}
        return transformer.lm_loss(unflatten(leaves), toks, cfg, prefix_embeds=pre,
                                   remat=remat, attn_impl=attn_impl)

    def local_train(rows: dict, mu: dict, nu: dict, count: Tensor, toks: Tensor,
                    pre: Tensor | None) -> Tensor:
        """``local_steps`` AdamW steps of one vehicle, written in place into
        its rows of the parameters and moments and its counter. Returns the
        mean loss."""
        losses = []
        for _ in range(local_steps):
            leaves = {name: row.detach().requires_grad_() for name, row in rows.items()}
            loss = loss_fn(leaves, toks, pre)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            del leaves
            with torch.no_grad():
                for name in list(grads):
                    g = {name: grads.pop(name)}
                    p = {name: rows[name]}
                    updates, new = optimizer.update(
                        g, AdamState(count=count, mu={name: mu[name]}, nu={name: nu[name]}), p)
                    mu[name].copy_(new.mu[name])
                    nu[name].copy_(new.nu[name])
                    rows[name].copy_(apply_updates(p, updates)[name])
                    del g, updates, new
                count += 1
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    def train_step(params: dict, opt_state: AdamState, state_matrix: Tensor, tokens: Tensor,
                   contact: Tensor, target: Tensor, prefix_embeds: Tensor | None = None):
        # -- P1: aggregation weights from the state vectors (Alg. 1 steps 1-2)
        with phase(timer, "p1_solve"):
            alpha = kl_solver.solve_p1_all(state_matrix, target, contact, num_steps=p1_steps)
            mixing = aggregation.mixing_from_alpha(alpha, contact)
        # -- the gossip mix of every vehicle's model (Eq. 10), into the stack
        flat = flatten(params)
        with phase(timer, "mix"), torch.no_grad():
            if mix_params_fn is None and _mixes_in_place(mixing):
                mix_params_cuda_(mixing, flat)
            else:
                mixed = (mix_params_fn or mix_params_cuda)(mixing, flat)
                for name, leaf in flat.items():
                    leaf.copy_(mixed[name])
                del mixed
        # -- E local iterations per vehicle (Eq. 3)
        mu, nu = flatten(opt_state.mu), flatten(opt_state.nu)
        losses = []
        with phase(timer, "local_train"):
            for v in range(tokens.shape[0]):
                losses.append(local_train(
                    _row(flat, v), _row(mu, v), _row(nu, v), opt_state.count[v], tokens[v],
                    None if prefix_embeds is None else prefix_embeds[v]))
        # -- the state vectors (Eqs. 5-7)
        with phase(timer, "state_update"):
            state_matrix = state_vector.aggregate(state_matrix, mixing)
            state_matrix = state_vector.local_update(state_matrix, lr, local_steps)
            metrics = {"loss": torch.stack(losses).mean(),
                       "kl": torch.mean(state_vector.kl_to_target(state_matrix, target))}
        return params, opt_state, state_matrix, metrics

    return TrainStep(fn=train_step)


def init_train_state(cfg: ArchConfig, num_vehicles: int, generator: torch.Generator,
                     dtype=torch.float32, device=None):
    """``(params, opt_state, state_matrix)`` of a federation of
    ``num_vehicles``: one model drawn from ``generator`` (on ``device``, the
    generator's when not given) copied to every vehicle, as the reference's
    ``broadcast_to(...).copy()``; AdamW's zero moments and ``[V]`` counters;
    the all-zero state matrix."""
    one = flatten(transformer.init_params(generator, cfg, dtype=dtype, device=device))
    flat = {name: leaf.unsqueeze(0).expand((num_vehicles,) + tuple(leaf.shape)).clone()
            for name, leaf in one.items()}
    del one
    opt = adamw(1e-4).init(flat, num_stacked=num_vehicles)
    return (unflatten(flat),
            AdamState(count=opt.count, mu=unflatten(opt.mu), nu=unflatten(opt.nu)),
            state_vector.init_state(num_vehicles, device=opt.count.device))


# -------------------------------------------------------------- serving -----

@dataclass
class ServeStep:
    fn: Callable


def build_prefill_step(cfg: ArchConfig, *, attn_impl=None,
                       window: int | None = None) -> ServeStep:
    """``fn(params, tokens, prefix_embeds=None)`` -> ``transformer.prefill``'s
    (last logits, DecodeState)."""
    def prefill_step(params, tokens, prefix_embeds=None):
        return transformer.prefill(params, tokens, cfg, prefix_embeds=prefix_embeds,
                                   window=window, attn_impl=attn_impl)

    return ServeStep(fn=prefill_step)


def build_decode_step(cfg: ArchConfig) -> ServeStep:
    """``fn(params, tokens, state)`` -> ``transformer.decode_step``'s (logits,
    DecodeState); the state's tensors are written in place."""
    def decode_fn(params, tokens, state):
        return transformer.decode_step(params, tokens, state, cfg)

    return ServeStep(fn=decode_fn)
