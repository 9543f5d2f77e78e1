"""Shared transformer building blocks: plain functions on tensors.

Counterpart of ``repro.models.layers`` with the same names, arguments and
layouts (``[d_in, d_out]`` weights, ``[..., S, H, hd]`` heads). Norms and
rotary embeddings compute in f32 and cast back to the input's dtype, as the
reference does.
"""
from __future__ import annotations

import functools
import inspect
import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def rms_norm(x: Tensor, weight: Tensor, eps: float = 1e-6) -> Tensor:
    x = whole_last_dim(x)
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * weight.to(torch.float32)
    return out.to(dtype)


def layer_norm(x: Tensor, weight: Tensor, bias: Tensor, eps: float = 1e-5) -> Tensor:
    x = whole_last_dim(x)
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = ((x - mu) * torch.rsqrt(var + eps) * weight.to(torch.float32)
           + bias.to(torch.float32))
    return out.to(dtype)


def rotary_cos_sin(positions: Tensor, head_dim: int,
                   theta: float = 1e4) -> tuple[Tensor, Tensor]:
    """cos/sin tables for the given integer positions. Returns [..., head_dim/2]."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exponents)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x: [..., S, H, hd]; cos/sin: [..., S, hd/2] (broadcast over heads).
    The two halves of hd rotate together (not interleaved pairs)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dtype)


def apply_rotary_interleaved(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """``apply_rotary`` on interleaved pairs ``(x[2i], x[2i + 1])`` (HF
    deepseek_v3's convention), returned in halves order ``[even ; odd]``, as
    HF's permute-then-rotate does: a query and a key rotated alike give the
    same dot product as rotated in place."""
    dtype = x.dtype
    x = x.to(torch.float32)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dtype)


def swiglu(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor) -> Tensor:
    """SwiGLU MLP: down( silu(x @ gate) * (x @ up) )."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: Tensor, w_up: Tensor, b_up: Tensor, w_down: Tensor,
             b_down: Tensor) -> Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ w_up + b_up, approximate="tanh") @ w_down + b_down


def embed(tokens: Tensor, table: Tensor) -> Tensor:
    if is_dtensor(table) or is_dtensor(tokens):
        return _embed_on_shards(tokens, table)
    return table[tokens.long()]


def _embed_on_shards(tokens: Tensor, table: Tensor) -> Tensor:
    """``embed`` of DTensors: over a mesh dim that shards the table's rows
    (vocabulary-parallel) each rank looks up the ids it holds, zeros for the
    others, a partial sum; over a mesh dim that shards the tokens, each rank
    its own; the table's width gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = (table if is_dtensor(table) else tokens).device_mesh
    t_pl = list(table.placements) if is_dtensor(table) else [Replicate()] * mesh.ndim
    k_pl = list(tokens.placements) if is_dtensor(tokens) else [Replicate()] * mesh.ndim
    table_to, tokens_to, out_to = [], [], []
    for m in range(mesh.ndim):
        if t_pl[m] == Shard(0):
            table_to.append(Shard(0)), tokens_to.append(Replicate()), out_to.append(Partial())
        elif k_pl[m] == Shard(0):
            table_to.append(Replicate()), tokens_to.append(Shard(0)), out_to.append(Shard(0))
        else:
            table_to.append(Replicate()), tokens_to.append(Replicate()), out_to.append(Replicate())
    rows = table.shape[0] // math.prod(mesh.size(m) for m in range(mesh.ndim)
                                       if table_to[m] == Shard(0))
    start = shard_offset(mesh, table_to, 0) * rows

    def lookup(ids, tab):
        at = ids.long() - start
        held = (at >= 0) & (at < tab.shape[0])
        found = tab[torch.clamp(at, 0, tab.shape[0] - 1)]
        return torch.where(held[..., None], found, torch.zeros((), dtype=tab.dtype,
                                                               device=tab.device))

    return on_shards(lookup, mesh, [(tokens, tokens_to), (table, table_to)], [out_to])


def unembed(x: Tensor, table: Tensor, true_vocab: int | None = None) -> Tensor:
    """Project to logits; padded vocab ids get the dtype's lowest value."""
    logits = x @ table
    if true_vocab is not None and true_vocab < table.shape[-1]:
        keep = torch.arange(table.shape[-1], device=logits.device) < true_vocab
        logits = torch.where(keep, logits, torch.finfo(logits.dtype).min)
    return logits


def causal_mask(q_len: int, kv_len: int, q_offset: Tensor | int = 0,
                window: int | None = None, device=None) -> Tensor:
    """[q_len, kv_len] boolean mask. True = attend.

    ``q_offset`` is the absolute position of query 0 relative to kv 0 (for
    decode with cache, q_offset = cache length). ``window`` keeps only the
    trailing ``window`` keys (sliding-window attention).
    """
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    return mask


def init_linear(generator: torch.Generator, shape: tuple[int, ...],
                scale: float | None = None, device=None) -> Tensor:
    """Normal weights of std ``scale`` (default ``shape[0] ** -0.5``, the
    fan-in of a ``[d_in, d_out]`` matrix), drawn from ``generator`` on
    ``device`` (the generator's device when not given)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    device = generator.device if device is None else device
    return scale * torch.randn(shape, generator=generator, dtype=torch.float32,
                               device=device)


def cross_entropy(logits: Tensor, labels: Tensor, ignore_id: int = -1) -> Tensor:
    """Mean token cross-entropy, skipping ``ignore_id`` positions."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    valid = labels != ignore_id
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = -torch.take_along_dim(logp, safe[..., None], dim=-1)[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return torch.sum(nll) / torch.clamp(torch.sum(valid), min=1)


# ----------------------------------------------------------- on a mesh -----
# The steps on a mesh (``launch.steps``) run these models on DTensors. Where
# DTensor's own sharding propagation would replicate the work, refuse the op
# (in some torch versions) or move or mislabel a buffer, the models call the
# helpers below; on plain tensors each is the single-device op, unchanged.

def is_dtensor(x) -> bool:
    if not isinstance(x, Tensor) or type(x) is Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def on_shards(fn, mesh, inputs: list, outputs: list):
    """``fn`` run on each rank's shards: ``inputs`` is a list of (tensor,
    placements) — each tensor (a DTensor, or a plain tensor taken as
    replicated) brought to those placements and handed to ``fn`` as its local
    tensor — and ``outputs`` the placements of ``fn``'s results, which come
    back as DTensors. Gradients flow: over a mesh dim where some input is
    sharded, an input held whole gets each rank's partial gradient (summed),
    and a partial output's gradient reaches every rank whole.

    This is how the models run the parts DTensor's own sharding propagation
    would take apart (attention's core, the dense MoE's experts, the RWKV
    recurrence, an embedding lookup): each is independent per batch row and
    per head or hidden block, so the shards compute alone."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    split = [any(isinstance(pl[m], Shard) for _, pl in inputs) for m in range(mesh.ndim)]
    local = []
    for x, pl in inputs:
        if not is_dtensor(x):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
        grads = [Partial() if split[m] and not isinstance(p, Shard) else p
                 for m, p in enumerate(pl)]
        local.append(x.redistribute(mesh, pl).to_local(grad_placements=grads))
    out = fn(*local)
    single = not isinstance(out, tuple)
    out = (out,) if single else out
    # a partial output's gradient reaches every rank whole: said where this
    # torch takes it, and DTensor's own rule where it does not (it keeps a
    # replicated gradient whole when the forward placement was partial)
    placed = tuple(DTensor.from_local(
        o, mesh, pl, run_check=False, **_global_meta(o, mesh, pl),
        **({"grad_placements": [Replicate() if p.is_partial() else p for p in pl]}
           if _from_local_takes_grad_placements() else {}))
        for o, pl in zip(out, outputs))
    return placed[0] if single else placed


def _global_meta(local: Tensor, mesh, placements) -> dict:
    """The global shape and stride of a DTensor of even shards ``local``,
    contiguous where ``local`` is. DTensor's own reckoning scales the stride
    of a size-1 dim along with a sharded one ([B, 1, d] sharded over B gets
    the stride of dim 1 doubled), and ``matmul`` then cannot fold such an
    input into one product: it expands the weight over the batch and copies
    it on every rank."""
    from torch.distributed.tensor import Shard
    if not local.is_contiguous():
        return {}
    shape = list(local.shape)
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            shape[p.dim % local.dim()] *= mesh.size(m)
    return {"shape": torch.Size(shape),
            "stride": torch.empty(shape, device="meta").stride()}


@functools.cache
def _from_local_takes_grad_placements() -> bool:
    from torch.distributed.tensor import DTensor
    return "grad_placements" in inspect.signature(DTensor.from_local).parameters


def shard_offset(mesh, placements, dim: int) -> int:
    """Where this rank's block of tensor dim ``dim`` starts, per unit of its
    (even) shard size: the rank's coordinates over the mesh dims that shard
    ``dim``, in mesh-dim order (major first)."""
    from torch.distributed.tensor import Shard
    index = 0
    for m, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            index = index * mesh.size(m) + mesh.get_local_rank(m)
    return index


def roll(x: Tensor, shift: int, dim: int) -> Tensor:
    """``torch.roll`` along ``dim``; on a DTensor not sharded over ``dim``,
    each rank rolls its shard."""
    if not is_dtensor(x):
        return torch.roll(x, shift, dims=dim)
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if isinstance(p, Shard) and p.dim % x.dim() == dim % x.dim() or
          p.is_partial() else p for p in x.placements]
    return on_shards(lambda t: torch.roll(t, shift, dims=dim), x.device_mesh, [(x, pl)], [pl])


def whole_last_dim(x: Tensor) -> Tensor:
    """``x`` with its last dim whole on every rank: on a DTensor, shards of
    the last dim gathered and partial sums reduced, other placements kept
    (the identity on a plain tensor). Every norm reads the whole hidden
    vector; without this a residual stream left sharded over its hidden dim
    (DTensor reduce-scatters a row-parallel output into it) would reach the
    next column-parallel product sharded the wrong way, and DTensor would
    gather both operands and compute it whole on every rank."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    last, mesh = x.dim() - 1, x.device_mesh
    # only over mesh dims of more than one rank: elsewhere the placements
    # already hold the whole value, and a redistribution would add a node to
    # the autograd graph (and change the order its gradients are summed in)
    placements = [Replicate() if mesh.size(m) > 1 and (
        p.is_partial() or (isinstance(p, Shard) and p.dim % x.dim() == last)) else p
                  for m, p in enumerate(x.placements)]
    return x if placements == list(x.placements) else x.redistribute(mesh, placements)


def split_heads(x: Tensor, heads: int, head_dim: int) -> Tensor:
    """``[..., heads * head_dim]`` -> ``[..., heads, head_dim]``. On a
    DTensor whose last dim is sharded over more ranks than there are heads
    (a GQA k / v projection of 8 or fewer heads column-parallel over 16),
    that dim is gathered first: DTensor cannot split a head across ranks."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        last, mesh = x.dim() - 1, x.device_mesh
        ranks = 1
        for m, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim % x.dim() == last:
                ranks *= mesh.size(m)
        if heads % ranks:
            placements = [Replicate() if isinstance(p, Shard) and p.dim % x.dim() == last
                          else p for p in x.placements]
            x = x.redistribute(mesh, placements)
    return x.reshape(tuple(x.shape[:-1]) + (heads, head_dim))


def empty_stack(n: int, like: Tensor, dtype=None) -> Tensor:
    """An uninitialised ``[n, *like.shape]`` buffer for a stack of ``like``s:
    on a DTensor, one whose every entry ``[i]`` is placed as ``like`` is (each
    rank holds the stack of its shards), so that writing a ``like`` into it
    moves nothing."""
    dtype = dtype or like.dtype
    if not is_dtensor(like):
        return torch.empty((n,) + tuple(like.shape), dtype=dtype, device=like.device)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    local = like.to_local()
    placements = [Shard(p.dim + 1) if isinstance(p, Shard) else Replicate()
                  for p in like.placements]
    return DTensor.from_local(
        torch.empty((n,) + tuple(local.shape), dtype=dtype, device=local.device),
        like.device_mesh, placements, run_check=False)


def write_slot(buf: Tensor, index: Tensor, new: Tensor) -> None:
    """``buf[:, index] = new`` in place (``index`` a one-entry long tensor,
    ``new`` one slot wide along dim 1). On a DTensor ``buf`` each rank writes
    into its own shard, and only where the slot falls inside its part of dim 1
    (a cache sharded over its sequence dim keeps every slot on one rank): no
    communication, no host read of ``index``."""
    if not is_dtensor(buf):
        buf.index_copy_(1, index, new)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh, local = buf.device_mesh, buf.to_local()
    start = shard_offset(mesh, buf.placements, 1) * local.shape[1]
    src = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in buf.placements]
    new = new.redistribute(mesh, src).to_local()
    index = index.full_tensor() if is_dtensor(index) else index
    at = index - start
    owned = (at >= 0) & (at < local.shape[1])
    at = torch.clamp(at, 0, local.shape[1] - 1)
    keep = local.index_select(1, at)
    local.index_copy_(1, at, torch.where(owned.reshape((1, 1) + (1,) * (new.dim() - 2)),
                                         new, keep))
