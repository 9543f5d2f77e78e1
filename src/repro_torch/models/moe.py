"""Mixture-of-Experts MLP: top-k router and two execution paths.

Counterpart of ``repro.models.moe`` (same names, parameter tree and layouts:
``router [d, E]``, ``w_gate`` / ``w_up [E, d, f]``, ``w_down [E, f, d]``):

* ``dense`` (the default, ``cfg.moe_impl``) computes every expert on every
  token and folds the router's combine weights into the down projection, so
  the ``[E, N, d]`` all-expert output is never built.
* ``ragged`` sorts the N*k (token, expert) assignments by expert (a stable
  sort, as ``jnp.argsort``), runs one product per expert on its contiguous
  slice where the reference calls ``jax.lax.ragged_dot``, and adds each
  output back to its token with ``index_add_``. The group sizes are read on
  the host. On CUDA ``index_add_`` uses atomics, so this path is not bitwise
  repeatable there: hold it to ``dense`` by tolerance.

Router: softmax over the expert logits in f32, top-k, the selected weights
renormalised (Mixtral's convention), and the Switch / GShard load-balance
loss, returned beside the output as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
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
        return _experts_on_shards(p, x, combine), aux
    return _experts(p, x, combine), aux


def _experts(p: dict, x: Tensor, combine: Tensor) -> Tensor:
    g = torch.matmul(x, p["w_gate"])                                          # [E, N, f]
    u = torch.matmul(x, p["w_up"])
    h = F.silu(g) * u * combine.T[:, :, None]
    return torch.einsum("enf,efd->nd", h, p["w_down"])


def _experts_on_shards(p: dict, x: Tensor, combine: Tensor) -> Tensor:
    """``_experts`` of DTensors (a mesh's steps), run on each rank's shards:
    over a mesh dim that shards the experts' hidden dim f (gate / up
    column-parallel, down row-parallel) each rank computes its f block for
    every token and the output is a partial sum there; over a mesh dim that
    shards the tokens, each rank its tokens; everything else gathered.
    (DTensor's own propagation would merge a sharded token dim into the
    broadcast products' batch dim, which some torch versions refuse.)"""
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

    names = list(w_to)
    return layers.on_shards(
        lambda x_l, c_l, *w_l: _experts(dict(zip(names, w_l)), x_l, c_l), mesh,
        [(x, x_to), (combine, x_to)] + [(p[name], w_to[name]) for name in names], [out_to])


def moe_ragged(p: dict, x: Tensor, cfg: ArchConfig) -> tuple[Tensor, Tensor]:
    """Dropless sorted dispatch: N*k assignments sorted by expert id, one
    SwiGLU per expert on its slice, outputs added back per token."""
    n = x.shape[0]
    e, k = cfg.num_experts, cfg.top_k
    weights, idx, aux = router_topk(x @ p["router"], k)

    flat_expert = idx.reshape(-1)                                             # [N*k]
    flat_token = torch.arange(n, device=x.device).repeat_interleave(k)       # [N*k]
    order = torch.argsort(flat_expert, stable=True)
    sorted_token = flat_token[order]
    sorted_weight = weights.reshape(-1)[order]
    xs = x[sorted_token]                                                      # [N*k, d]
    group_sizes = torch.bincount(flat_expert, minlength=e).tolist()

    y = torch.empty_like(xs)
    start = 0
    for j, size in enumerate(group_sizes):
        rows = slice(start, start + size)
        y[rows] = layers.swiglu(xs[rows], p["w_gate"][j], p["w_up"][j], p["w_down"][j])
        start += size
    out = torch.zeros_like(x).index_add_(0, sorted_token, y * sorted_weight[:, None])
    return out, aux


def moe_ffn(p: dict, x: Tensor, cfg: ArchConfig) -> tuple[Tensor, Tensor]:
    """Dispatch on ``cfg.moe_impl``. x may be [B, S, d] or [N, d]."""
    shape = x.shape
    fn = moe_ragged if cfg.moe_impl == "ragged" else moe_dense
    out, aux = fn(p, x.reshape(-1, shape[-1]), cfg)
    return out.reshape(shape), aux
