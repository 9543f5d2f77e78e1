"""Mixture-of-Experts MLP: top-k router and two execution paths.

Counterpart of ``repro.models.moe`` (same names, parameter tree and layouts:
``router [d, E]``, ``w_gate`` / ``w_up [E, d, f]``, ``w_down [E, f, d]``):

* ``dense`` (the default, ``cfg.moe_impl``) computes every expert on every
  token and folds the router's combine weights into the down projection, so
  the ``[E, N, d]`` all-expert output is never built.
* ``ragged`` sorts the N*k (token, expert) assignments by expert (a stable
  sort, as ``jnp.argsort``), finds each expert's slice as offsets on the
  device (``searchsorted`` of the sorted ids: static shapes, nothing read on
  the host, so it runs on meta tensors), runs the three SwiGLU products as
  grouped products over those slices where the reference calls
  ``jax.lax.ragged_dot`` (``kernels.grouped_mm``: the hand-written kernel on
  CUDA, its plain version on the CPU), and adds each output back to its token
  with ``index_add_``. On CUDA ``index_add_`` uses atomics, so this path is
  not bitwise repeatable there: hold it to ``dense`` by tolerance.

Router: softmax over the expert logits in f32, top-k, the selected weights
renormalised (Mixtral's convention), and the Switch / GShard load-balance
loss, returned beside the output as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.grouped_mm import ops as grouped
from . import layers

Tensor = torch.Tensor


def init_moe(generator: torch.Generator, cfg: ArchConfig, device=None,
             num_layers: int | None = None) -> dict:
    """One layer's MoE weights, or ``num_layers`` stacked on ``[L, ...]``. The
    reference draws the ``[E, ...]`` expert stacks with ``init_linear``, whose
    fan-in is the leading axis: their scale is ``E ** -0.5``, kept here."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = () if num_layers is None else (num_layers,)

    def draw(shape, scale):
        return layers.init_linear(generator, lead + shape, scale=scale, device=device)

    return {"router": draw((d, e), d ** -0.5), "w_gate": draw((e, d, f), e ** -0.5),
            "w_up": draw((e, d, f), e ** -0.5), "w_down": draw((e, f, d), e ** -0.5)}


def router_topk(logits: Tensor, top_k: int) -> tuple[Tensor, Tensor, Tensor]:
    """Returns (weights [N, k], indices [N, k], aux_loss 0-d)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    weights, idx = torch.topk(probs, top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-9)
    # load-balance loss: E * sum_e f_e * p_e
    e = logits.shape[-1]
    frac_routed = F.one_hot(idx, e).to(torch.float32).sum(dim=1).mean(dim=0)   # [E]
    mean_prob = probs.mean(dim=0)                                               # [E]
    aux = e * torch.sum(frac_routed * mean_prob)
    return weights.to(logits.dtype), idx, aux


def moe_dense(p: dict, x: Tensor, cfg: ArchConfig) -> tuple[Tensor, Tensor]:
    """Dense-compute path. x: [N, d] -> ([N, d], aux_loss).

        out[n, :] = sum_{e,f} (c[n, e] * h[e, n, f]) Wd[e, f, :]

    one product over (e, f) together, as the reference's einsum."""
    weights, idx, aux = router_topk(x @ p["router"], cfg.top_k)
    # the top-k ids of a row are distinct: each (n, e) holds one weight or 0
    combine = weights.new_zeros((x.shape[0], cfg.num_experts)).scatter_(1, idx, weights)  # [N, E]
    if layers.is_dtensor(x):
        return _on_shards(_experts, p, x, [combine]), aux
    return _experts(p, x, combine), aux


def _experts(p: dict, x: Tensor, combine: Tensor) -> Tensor:
    g = torch.matmul(x, p["w_gate"])                                          # [E, N, f]
    u = torch.matmul(x, p["w_up"])
    h = F.silu(g) * u * combine.T[:, :, None]
    return torch.einsum("enf,efd->nd", h, p["w_down"])


def _on_shards(fn, p: dict, x: Tensor, per_token: list) -> Tensor:
    """``fn(weights, x, *per_token)`` (either path's experts) on DTensors (a
    mesh's steps), run on each rank's shards; ``per_token`` are [N, ...]
    tensors placed as the tokens. Over a mesh dim that shards the experts'
    hidden dim f (gate / up column-parallel, down row-parallel) each rank
    computes its f block for every token and the output is a partial sum
    there; over a mesh dim that shards the tokens, each rank its tokens;
    everything else gathered. (DTensor's own propagation would merge a
    sharded token dim into the broadcast products' batch dim, which some
    torch versions refuse, and cannot run the grouped products at all.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    w_to, x_to, out_to = {"w_gate": [], "w_up": [], "w_down": []}, [], []
    for m in range(mesh.ndim):
        f_sharded = all(layers.is_dtensor(p[name]) and p[name].placements[m] == Shard(dim)
                        for name, dim in (("w_gate", 2), ("w_up", 2), ("w_down", 1)))
        for name, dim in (("w_gate", 2), ("w_up", 2), ("w_down", 1)):
            w_to[name].append(Shard(dim) if f_sharded else Replicate())
        tokens = not f_sharded and x.placements[m] == Shard(0)
        x_to.append(Shard(0) if tokens else Replicate())
        out_to.append(Partial() if f_sharded else Shard(0) if tokens else Replicate())

    names, t = list(w_to), len(per_token)
    return layers.on_shards(
        lambda x_l, *rest: fn(dict(zip(names, rest[t:])), x_l, *rest[:t]), mesh,
        [(x, x_to)] + [(y, x_to) for y in per_token]
        + [(p[name], w_to[name]) for name in names], [out_to])


def moe_ragged(p: dict, x: Tensor, cfg: ArchConfig) -> tuple[Tensor, Tensor]:
    """Dropless sorted dispatch: N*k assignments sorted by expert id, the
    SwiGLU's three products grouped over the experts' slices, outputs added
    back per token."""
    weights, idx, aux = router_topk(x @ p["router"], cfg.top_k)
    if layers.is_dtensor(x):
        return _on_shards(lambda w, *local: _ragged(w, *local, cfg.num_experts),
                          p, x, [weights, idx]), aux
    return _ragged(p, x, weights, idx, cfg.num_experts), aux


def _ragged(p: dict, x: Tensor, weights: Tensor, idx: Tensor, e: int) -> Tensor:
    k = idx.shape[1]
    flat_expert = idx.reshape(-1)                                             # [N*k]
    order = torch.argsort(flat_expert, stable=True)
    sorted_token = order // k                  # flat index n*k + j belongs to token n
    sorted_weight = weights.reshape(-1)[order]
    # offsets[e] = the number of assignments to experts below e
    offsets = torch.searchsorted(flat_expert[order],
                                 torch.arange(e + 1, device=x.device, dtype=idx.dtype),
                                 out_int32=True)
    xs = x[sorted_token]                                                      # [N*k, d]
    g = grouped.grouped_mm(xs, p["w_gate"], offsets)
    u = grouped.grouped_mm(xs, p["w_up"], offsets)
    y = grouped.grouped_mm(F.silu(g) * u, p["w_down"], offsets)
    return torch.zeros_like(x).index_add_(0, sorted_token, y * sorted_weight[:, None])


def moe_ffn(p: dict, x: Tensor, cfg: ArchConfig) -> tuple[Tensor, Tensor]:
    """Dispatch on ``cfg.moe_impl``. x may be [B, S, d] or [N, d]."""
    shape = x.shape
    fn = moe_ragged if cfg.moe_impl == "ragged" else moe_dense
    out, aux = fn(p, x.reshape(-1, shape[-1]), cfg)
    return out.reshape(shape), aux
