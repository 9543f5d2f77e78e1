"""Sharding specs for every parameter and state tree, and their DTensor
placements.

Counterpart of ``repro.launch.sharding``. A spec (``P``) has one entry per
tensor dimension: the name of the mesh dim it is sharded over, a tuple of
names (sharded over their product, the first name major), or ``None``
(replicated) — the reading of ``jax.sharding.PartitionSpec``. Missing
trailing entries are ``None``. ``placements`` turns a spec into the DTensor
placements of one tensor on a ``DeviceMesh`` (``launch.mesh``'s dims
``vehicle`` / ``fsdp`` / ``model``, or ``data`` / ``model``).

Baseline layout (Megatron-style TP over "model" + optional FSDP over "fsdp"):
  attention : QKV column-parallel (heads), O row-parallel
  MLP       : gate/up column-parallel (d_ff), down row-parallel
  MoE       : per-expert d_ff tensor-parallel (expert dim not sharded)
  embed     : vocab-sharded; lm_head vocab-sharded on the output dim
  rwkv6     : inner width (padded heads x head_dim) column-parallel
  ssm       : d_inner channel-parallel

KV projections whose width is not divisible by the model-parallel degree
(GQA kv in {1, 2, 5}) are replicated — the replicate-KV regime.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard
from torch.utils import _pytree as pytree

from ..configs.base import ArchConfig

PyTree = Any


class P(tuple):
    """An immutable sharding spec: ``P("vehicle", None, "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


def is_spec(x) -> bool:
    return isinstance(x, P)


def tree_map_specs(fn, tree: PyTree) -> PyTree:
    """``fn`` over every ``P`` of a tree of dicts / (named) tuples."""
    return pytree.tree_map(fn, tree, is_leaf=is_spec)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of a tensor with sharding ``spec`` on ``mesh``:
    for each mesh dim, ``Shard(d)`` where the spec names it at tensor dim
    ``d``, else ``Replicate()``. A dim named by no mesh dim raises."""
    dims = tuple(mesh.mesh_dim_names)
    where: dict[str, int] = {}
    for d, entry in enumerate(spec):
        for name in _names(entry):
            if name not in dims:
                raise ValueError(f"spec {spec} names {name!r}, not a dim of the mesh {dims}")
            if name in where:
                raise ValueError(f"spec {spec} names {name!r} twice")
            where[name] = d
    return tuple(Shard(where[name]) if name in where else Replicate() for name in dims)


def placements_tree(spec_tree: PyTree, mesh) -> PyTree:
    """``placements`` over every spec of a tree."""
    return tree_map_specs(lambda s: placements(s, mesh), spec_tree)


def place(x, mesh, spec: P, *, local_axes: tuple = ()):
    """``x`` as a DTensor on ``mesh`` placed by ``spec``. A DTensor is
    redistributed where its placements differ. A plain tensor or a numpy
    array holds the global values (the same on every rank) and is cut to this
    rank's block, as DTensor cuts (``torch.chunk``'s blocks, in mesh-dim
    order): a tensor as a view of it (no communication, no copy: a second
    copy of a full-width federation does not fit the card), a numpy array on
    the host, only its block copied to the mesh's device type.
    ``local_axes`` names mesh dims whose cut ``x`` has already taken: along
    the tensor dims they shard it holds only this rank's block (such as a
    rank's own vehicle rows)."""
    from torch.distributed.tensor import DTensor

    pl = placements(spec, mesh)
    if isinstance(x, DTensor):
        return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
    shape, local = list(x.shape), x
    for m, (p, c) in enumerate(zip(pl, mesh.get_coordinate())):
        if not isinstance(p, Shard):
            continue
        n = mesh.size(m)
        if mesh.mesh_dim_names[m] in local_axes:
            shape[p.dim] *= n
            continue
        size = -(-local.shape[p.dim] // n)
        start = min(c * size, local.shape[p.dim])
        stop = min(start + size, local.shape[p.dim])
        local = local[(slice(None),) * p.dim + (slice(start, stop),)]
    if isinstance(local, np.ndarray):
        local = torch.tensor(np.ascontiguousarray(local), device=mesh.device_type)
    stride = (x.stride() if isinstance(x, torch.Tensor) and not local_axes
              else torch.empty(shape, device="meta").stride())
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=torch.Size(shape),
                              stride=stride)


def place_tree(tree: PyTree, mesh, specs: PyTree, **kw) -> PyTree:
    """``place`` over a tree of dicts / (named) tuples and its spec tree
    (None subtrees pass); ``kw`` go to every ``place``."""
    if specs is None or tree is None:
        return tree
    if isinstance(specs, P):
        return place(tree, mesh, specs, **kw)
    if isinstance(specs, dict):
        return {name: place_tree(tree[name], mesh, specs[name], **kw) for name in tree}
    items = [place_tree(x, mesh, s, **kw) for x, s in zip(tree, specs)]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def drop_leading(spec: P, n: int = 1) -> P:
    """The spec of a tensor's trailing dims: ``spec`` without its first
    ``n`` entries (a row of a stacked leaf)."""
    return P(*spec[n:])


# ------------------------------------------------------------ per family ----

def _attn_specs(cfg: ArchConfig, model: str, fsdp) -> dict:
    if cfg.is_mla:
        # heads over the model axis; the latent projection and its norm whole
        return {"wq": P(None, fsdp, model), "wkv_a": P(None, fsdp, None),
                "kv_norm": P(None, None), "wkv_b": P(None, None, model),
                "wo": P(None, model, fsdp)}
    kv_ok = (cfg.num_kv_heads * cfg.head_dim) % 16 == 0
    kvs = model if kv_ok else None
    spec = {
        "wq": P(None, fsdp, model),
        "wk": P(None, fsdp, kvs),
        "wv": P(None, fsdp, kvs),
        "wo": P(None, model, fsdp),
    }
    if cfg.qkv_bias:
        spec["bq"] = P(None, model)
        spec["bk"] = P(None, kvs)
        spec["bv"] = P(None, kvs)
    if cfg.qk_norm:
        spec["q_norm"] = P(None, None)
        spec["k_norm"] = P(None, None)
    return spec


def _mlp_specs(model: str, fsdp) -> dict:
    return {
        "w_gate": P(None, fsdp, model),
        "w_up": P(None, fsdp, model),
        "w_down": P(None, model, fsdp),
    }


def _moe_specs(cfg: ArchConfig, model: str, fsdp) -> dict:
    spec = {
        "router": P(None, fsdp, None),
        "w_gate": P(None, None, fsdp, model),
        "w_up": P(None, None, fsdp, model),
        "w_down": P(None, None, model, fsdp),
    }
    if cfg.router == "sigmoid":
        spec["router_bias"] = P(None, None)
    if cfg.shared_experts:
        spec["shared"] = _mlp_specs(model, fsdp)
    return spec


def _time_mix_specs(model: str, fsdp) -> dict:
    return {
        "mix_mu": P(None, None, None),
        "mix_w1": P(None, fsdp, None),
        "mix_w2": P(None, None, None, None),
        "wr": P(None, fsdp, model),
        "wk": P(None, fsdp, model),
        "wv": P(None, fsdp, model),
        "wg": P(None, fsdp, model),
        "wo": P(None, model, fsdp),
        "decay_w0": P(None, model),
        "decay_w1": P(None, fsdp, None),
        "decay_w2": P(None, None, model),
        "bonus_u": P(None, model, None),
        "ln_x": P(None, model),
    }


def _channel_mix_specs(model: str, fsdp) -> dict:
    return {
        "mix_k": P(None, None),
        "mix_r": P(None, None),
        "wk": P(None, fsdp, model),
        "wv": P(None, model, fsdp),
        "wr": P(None, None, model),
    }


def _ssm_specs(model: str, fsdp) -> dict:
    return {
        "in_proj": P(None, fsdp, model),
        "conv_w": P(None, None, model),
        "conv_b": P(None, model),
        "x_proj": P(None, model, None),
        "dt_proj": P(None, None, model),
        "dt_bias": P(None, model),
        "log_a": P(None, model, None),
        "d_skip": P(None, model),
        "out_proj": P(None, model, fsdp),
    }


def build_param_specs(cfg: ArchConfig, *, model: str = "model",
                      fsdp: str | None = None) -> dict:
    """Spec tree mirroring ``models.transformer.init_params(cfg)``."""
    blocks: dict = {"norm1": P(None, None), "norm2": P(None, None)}
    dense_blocks = None
    if cfg.first_dense_layers:
        dense_blocks = dict(blocks, attn=_attn_specs(cfg, model, fsdp),
                            mlp=_mlp_specs(model, fsdp))
    if cfg.family == "ssm":
        blocks["norm1_b"] = P(None, None)
        blocks["norm2_b"] = P(None, None)
        blocks["time_mix"] = _time_mix_specs(model, fsdp)
        blocks["channel_mix"] = _channel_mix_specs(model, fsdp)
    else:
        blocks["attn"] = _attn_specs(cfg, model, fsdp)
        if cfg.hybrid:
            blocks["ssm"] = _ssm_specs(model, fsdp)
            blocks["branch_norm_attn"] = P(None, None)
            blocks["branch_norm_ssm"] = P(None, None)
        if cfg.is_moe:
            blocks["moe"] = _moe_specs(cfg, model, fsdp)
        else:
            blocks["mlp"] = _mlp_specs(model, fsdp)

    specs = {
        "embed": P(model, None),
        "blocks": blocks,
        "final_norm": P(None),
    }
    if cfg.family == "ssm":
        specs["final_norm_b"] = P(None)
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, model)
    if dense_blocks is not None:
        specs["dense_blocks"] = dense_blocks
    return specs


def prepend_axes(specs: PyTree, lead: tuple) -> PyTree:
    """Prepend leading sharded dims (e.g. the stacked vehicle axis) to every
    spec in the tree."""
    return tree_map_specs(lambda s: P(*lead, *s), specs)


def decode_state_specs(cfg: ArchConfig, batch_axes, model: str = "model"):
    """Specs for ``models.transformer.DecodeState`` (leading [L] layer-stack
    dim).

    KV cache: batch over the data axes; kv-head dim over "model" when the
    (padded) kv count divides 16, else the cache is sharded over its
    sequence dim (T) — the reference's flash-decode-style layout, which
    leaves a per-layer logits gather and a small output sum where replicating
    would regather the cache every step. Returns a DecodeState of specs.
    """
    from ..models.attention import KVCache
    from ..models.transformer import DecodeState

    b = batch_axes if isinstance(batch_axes, tuple) else (batch_axes,)
    b = b[0] if len(b) == 1 else b
    kv = rk = sm = None
    if not cfg.attn_free:
        if cfg.num_kv_heads % 16 == 0:
            kvs, seqs = model, None
        else:
            kvs, seqs = None, model
        kv = KVCache(
            k=P(None, b, seqs, kvs, None),
            v=P(None, b, seqs, kvs, None),
            length=P(None),
        )
    if cfg.family == "ssm":
        rk = {
            "shift": P(None, b, None),
            "wkv": P(None, b, model, None, None),
            "cm_shift": P(None, b, None),
        }
    if cfg.hybrid:
        sm = {
            "conv": P(None, b, None, model),
            "h": P(None, b, model, None),
        }
    return DecodeState(kv=kv, rwkv=rk, ssm=sm, position=P())
