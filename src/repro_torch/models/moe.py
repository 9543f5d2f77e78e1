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

deepseek_v3's MoE (``cfg.router == "sigmoid"``, port-only): sigmoid scores
``s`` over all experts; the top-k of ``s + router_bias`` chosen (the bias
selects and weighs nothing, so its gradient is 0); weights ``s[top]``
renormalised and scaled by ``cfg.routed_scale``; DeepSeek-V3's
sequence-wise balance loss; shared experts
(``p["shared"]``, one SwiGLU) added to every token.

An expert share (``cfg.held_experts``, ``[lo, hi)`` of the router's
``num_experts``): the router scores every expert, the expert stacks hold
``hi - lo``, and each path computes the held experts' part of the output
alone (dense: the held columns of the combine weights; ragged: offsets over
the held range of the sorted assignments, so rows routed elsewhere lie
outside every group and give 0, with nothing read on the host). Holding
every expert is the path above, unchanged. With a ``PhaseTimer`` the rows
routed to held experts are summed on the device (counter
``moe.held_rows``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.grouped_mm import ops as grouped
from ..profiling import PhaseTimer
from . import layers

Tensor = torch.Tensor

# the selection bias drawn at init: large enough to change many tokens' top-k
ROUTER_BIAS_STD = 0.05


def init_moe(generator: torch.Generator, cfg: ArchConfig, device=None,
             num_layers: int | None = None) -> dict:
    """One layer's MoE weights, or ``num_layers`` stacked on ``[L, ...]``. The
    reference draws the ``[E, ...]`` expert stacks with ``init_linear``, whose
    fan-in is the leading axis: their scale is ``E ** -0.5``, kept here."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = () if num_layers is None else (num_layers,)

    def draw(shape, scale):
        return layers.init_linear(generator, lead + shape, scale=scale, device=device)

    if cfg.router == "sigmoid":
        lo, hi = cfg.held_experts
        fs = cfg.shared_experts * f
        return {"router": draw((d, e), d ** -0.5),
                "router_bias": draw((e,), ROUTER_BIAS_STD),
                "w_gate": draw((hi - lo, d, f), d ** -0.5),
                "w_up": draw((hi - lo, d, f), d ** -0.5),
                "w_down": draw((hi - lo, f, d), f ** -0.5),
                "shared": {"w_gate": draw((d, fs), d ** -0.5), "w_up": draw((d, fs), d ** -0.5),
                           "w_down": draw((fs, d), fs ** -0.5)}}
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


def router_sigmoid(logits: Tensor, bias: Tensor, top_k: int, scale: float,
                   batch: int = 1) -> tuple[Tensor, Tensor, Tensor]:
    """deepseek_v3's router (``noaux_tc``, one group). Returns (weights
    [N, k], indices [N, k], aux_loss 0-d): the top-k of ``sigmoid(logits) +
    bias``, weighed by the sigmoid scores alone, renormalised and scaled.
    The aux loss is DeepSeek-V3's sequence-wise balance loss (arXiv
    2412.19437 Sec. 2.1.2) over the ``batch`` sequences of the N rows, without
    its weight: per sequence ``sum_i f_i P_i``, ``f_i = E / (k T) x`` the
    tokens choosing i, ``P_i`` the mean of the scores normalised over the
    experts; the mean over sequences. ``f_i`` counts the biased selection
    that the layer runs, as Megatron-style implementations do; the paper's
    eq. 18 writes the top-k of the plain scores."""
    f32 = torch.float32
    s = torch.sigmoid(logits.to(f32))
    idx = torch.topk(s + bias.to(f32), top_k, dim=-1).indices
    weights = torch.gather(s, 1, idx)
    weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20) * scale
    n, e = s.shape
    chosen = s.new_zeros((n, e)).scatter_(1, idx, 1.0).view(batch, n // batch, e)
    share = (s / s.sum(dim=-1, keepdim=True)).view(batch, n // batch, e)
    aux = torch.sum(chosen.mean(dim=1) * (e / top_k) * share.mean(dim=1), dim=-1).mean()
    return weights.to(logits.dtype), idx, aux


def route(p: dict, x: Tensor, cfg: ArchConfig, batch: int = 1) -> tuple[Tensor, Tensor, Tensor]:
    """The config's router on x [N, d] (``batch`` sequences of N / batch)."""
    if cfg.router == "sigmoid":
        return router_sigmoid(x @ p["router"], p["router_bias"], cfg.top_k, cfg.routed_scale,
                              batch)
    return router_topk(x @ p["router"], cfg.top_k)


def moe_dense(p: dict, x: Tensor, cfg: ArchConfig, batch: int = 1,
              timer: PhaseTimer | None = None) -> tuple[Tensor, Tensor]:
    """Dense-compute path. x: [N, d] -> ([N, d], aux_loss).

        out[n, :] = sum_{e,f} (c[n, e] * h[e, n, f]) Wd[e, f, :]

    one product over (e, f) together, as the reference's einsum; of an
    expert share, over the held experts' columns of c."""
    weights, idx, aux = route(p, x, cfg, batch)
    # the top-k ids of a row are distinct: each (n, e) holds one weight or 0
    combine = weights.new_zeros((x.shape[0], cfg.num_experts)).scatter_(1, idx, weights)  # [N, E]
    lo, hi = cfg.held_experts
    if (lo, hi) != (0, cfg.num_experts):
        combine = combine[:, lo:hi]
    if timer is not None:
        timer.count("moe.held_rows", ((idx >= lo) & (idx < hi)).sum())
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


def moe_ragged(p: dict, x: Tensor, cfg: ArchConfig, batch: int = 1,
               timer: PhaseTimer | None = None) -> tuple[Tensor, Tensor]:
    """Dropless sorted dispatch: N*k assignments sorted by expert id, the
    SwiGLU's three products grouped over the held experts' slices, outputs
    added back per token."""
    weights, idx, aux = route(p, x, cfg, batch)
    lo, hi = cfg.held_experts
    if layers.is_dtensor(x):
        return _on_shards(lambda w, *local: _ragged(w, *local, hi - lo, lo),
                          p, x, [weights, idx]), aux
    return _ragged(p, x, weights, idx, hi - lo, lo, timer), aux


def _ragged(p: dict, x: Tensor, weights: Tensor, idx: Tensor, e: int, lo: int = 0,
            timer: PhaseTimer | None = None) -> Tensor:
    """The ``e`` held experts from ``lo`` on; assignments to other experts
    sort before ``offsets[0]`` or after ``offsets[e]`` and give 0."""
    k = idx.shape[1]
    flat_expert = idx.reshape(-1)                                             # [N*k]
    order = torch.argsort(flat_expert, stable=True)
    sorted_token = order // k                  # flat index n*k + j belongs to token n
    sorted_weight = weights.reshape(-1)[order]
    # offsets[e] = the number of assignments to experts below e
    offsets = torch.searchsorted(flat_expert[order],
                                 torch.arange(lo, lo + e + 1, device=x.device, dtype=idx.dtype),
                                 out_int32=True)
    if timer is not None:
        timer.count("moe.held_rows", offsets[-1] - offsets[0])
    xs = x[sorted_token]                                                      # [N*k, d]
    g = grouped.grouped_mm(xs, p["w_gate"], offsets)
    u = grouped.grouped_mm(xs, p["w_up"], offsets)
    y = grouped.grouped_mm(F.silu(g) * u, p["w_down"], offsets)
    return torch.zeros_like(x).index_add_(0, sorted_token, y * sorted_weight[:, None])


def moe_ffn(p: dict, x: Tensor, cfg: ArchConfig,
            timer: PhaseTimer | None = None) -> tuple[Tensor, Tensor]:
    """Dispatch on ``cfg.moe_impl``, plus the shared experts. x may be
    [B, S, d] (B sequences for a sequence-wise aux loss) or [N, d]."""
    shape = x.shape
    flat = x.reshape(-1, shape[-1])
    batch = shape[0] if x.dim() == 3 and cfg.router == "sigmoid" else 1
    fn = moe_ragged if cfg.moe_impl == "ragged" else moe_dense
    out, aux = fn(p, flat, cfg, batch, timer)
    if cfg.shared_experts:
        sh = p["shared"]
        out = out + layers.swiglu(flat, sh["w_gate"], sh["w_up"], sh["w_down"])
    return out.reshape(shape), aux
