"""GQA multi-head attention: train / prefill and cached decode paths; latent
attention (MLA) for training.

Counterpart of ``repro.models.attention``: grouped-query attention (any
kv <= q head ratio), rotary embeddings, optional QKV bias (qwen1.5/2.5),
optional per-head q/k RMSNorm (qwen3), optional sliding window. Parameters
are a dictionary of tensors with the reference's names and ``[d_in, d_out]``
layouts.

``attn_impl`` is the hook for a kernel with ``_sdpa``'s signature
``(q, k, v, mask, scale)`` — ``kernels.flash_attention.make_attn_impl()``.
The ``[S, S]`` mask is built for the plain ``_sdpa`` only: an ``attn_impl``
gets ``None`` there and takes the causal (+ window) structure from its own
flags, as the flash adapter does (the reference builds the mask and the
adapter drops it; eager PyTorch would pay for it in every layer).
``blocked_sdpa`` / ``make_blocked_impl`` are the reference's plain twin of the
flash kernel (an online softmax over q and kv blocks): an ``attn_impl`` for
tests and for ``launch/variants.py``; no path on the card runs them.

Latent attention (``cfg.is_mla``, deepseek_v3 with no query compression;
a port-only architecture, no counterpart in the reference): ``q = h wq``,
per head ``[q_nope ; q_pe]``; ``[c, k_pe] = h wkv_a``, ``c`` RMS-normed by
``kv_norm``; ``[k_nope, v] = c wkv_b`` per head; rotary on interleaved pairs
of ``q_pe`` and of the one ``k_pe`` every head shares; causal softmax of
``q.k / sqrt(head_dim)`` over ``k = [k_nope ; k_pe]``; ``o = p v`` at the
value width ``cfg.value_dim``, out through ``wo``. It trains and does not
serve (no latent KV cache yet): ``transformer.prefill`` and
``init_decode_state`` refuse it.

Decode writes the new token's k/v into the cache **in place** (the returned
``KVCache`` shares the input's tensors): the reference's
``dynamic_update_slice`` returns a new cache, which a Python loop here
would copy, whole, per layer and step. Positions and slots stay tensors, so
a decode step does not synchronise with the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.base import ArchConfig
from . import layers

Tensor = torch.Tensor


def init_attn(generator: torch.Generator, cfg: ArchConfig, device=None,
              num_layers: int | None = None) -> dict:
    """Attention weights of one layer, or of ``num_layers`` layers stacked on
    a leading ``[L, ...]`` axis (each layer drawn at its own fan-in)."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    device = generator.device if device is None else device
    lead = () if num_layers is None else (num_layers,)

    def linear(d_in, d_out):
        return layers.init_linear(generator, lead + (d_in, d_out), scale=d_in ** -0.5,
                                  device=device)

    def const(value, n):
        return torch.full(lead + (n,), value, dtype=torch.float32, device=device)

    if cfg.is_mla:
        r, nope, vd = cfg.kv_lora_rank, hd - cfg.qk_rope_dim, cfg.value_dim
        return {"wq": linear(d, h * hd), "wkv_a": linear(d, r + cfg.qk_rope_dim),
                "kv_norm": const(1.0, r), "wkv_b": linear(r, h * (nope + vd)),
                "wo": linear(h * vd, d)}
    p = {"wq": linear(d, h * hd), "wk": linear(d, kv * hd), "wv": linear(d, kv * hd),
         "wo": linear(h * hd, d)}
    if cfg.qkv_bias:
        p["bq"], p["bk"], p["bv"] = const(0.0, h * hd), const(0.0, kv * hd), const(0.0, kv * hd)
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = const(1.0, hd), const(1.0, hd)
    # zero the W_o rows of padded q-heads so padding is mathematically inert
    if cfg.true_num_heads < cfg.num_heads:
        p["wo"][..., cfg.true_num_heads * hd:, :] = 0.0
    return p


def _project_qkv(p: dict, x: Tensor, cfg: ArchConfig, positions: Tensor):
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = layers.split_heads(q, h, hd)
    k = layers.split_heads(k, kv, hd)
    v = layers.split_heads(v, kv, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = layers.rotary_cos_sin(positions, hd, cfg.rope_theta)
    q = layers.apply_rotary(q, cos, sin)
    k = layers.apply_rotary(k, cos, sin)
    return q, k, v


def _sdpa(q: Tensor, k: Tensor, v: Tensor, mask: Tensor, scale: float) -> Tensor:
    """Plain scaled-dot-product attention with GQA head grouping.

    q: [B, S, H, hd]; k/v: [B, T, KV, hd]; mask: [S, T] or [B, S, T] bool.
    Both contractions in f32 (a bf16 cache is widened, as the reference's
    ``preferred_element_type=f32`` does), masked logits at f32's lowest value.
    v may have its own head width (latent attention's), which the output
    takes. DTensors (a mesh's steps) go through ``_sdpa_on_shards``.
    """
    if layers.is_dtensor(q) or layers.is_dtensor(k):
        return _sdpa_on_shards(q, k, v, mask, scale)
    b, s, h, hd = q.shape
    kv = k.shape[2]
    group = h // kv
    f32 = torch.float32
    qg = q.reshape(b, s, kv, group, hd).to(k.dtype).to(f32)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.to(f32)) * scale
    mask_b = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
    logits = torch.where(mask_b, logits, torch.finfo(f32).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype).to(f32), v.to(f32))
    return out.reshape(b, s, h, v.shape[-1]).to(q.dtype)


def _sdpa_on_shards(q: Tensor, k: Tensor, v: Tensor, mask: Tensor, scale: float) -> Tensor:
    """``_sdpa`` of DTensors, run on each rank's shards (``layers.on_shards``):
    attention is independent per sequence and per group of heads, so each
    rank attends its own batch rows and q heads to the k / v heads they read.
    q keeps a batch sharding and one mesh dim's head sharding (other
    placements gathered); k, v and a batched mask take the same batch
    sharding, and k / v the same head blocks where their heads divide over
    that mesh dim, else they are gathered whole and each rank takes the heads
    its q heads read (so a cache sharded over its sequence dim is gathered).
    The output is placed as q. (DTensor's own propagation would merge sharded
    batch and head dims into the products' batch dim, which some torch
    versions refuse.)"""
    from torch.distributed.tensor import Replicate, Shard

    mesh = (q if layers.is_dtensor(q) else k).device_mesh
    h, kv = q.shape[2], k.shape[2]
    q_to, kv_to, mask_to = [], [], []
    head_dim_of = None                  # the mesh dim q's heads stay sharded over
    for m, p in enumerate(q.placements if layers.is_dtensor(q) else [Replicate()] * mesh.ndim):
        n = mesh.size(m)
        if isinstance(p, Shard) and p.dim == 0:
            q_to.append(Shard(0)), kv_to.append(Shard(0))
            mask_to.append(Shard(0) if mask.dim() == 3 else Replicate())
            continue
        if isinstance(p, Shard) and p.dim == 2 and head_dim_of is None and h % n == 0:
            head_dim_of = m
            q_to.append(Shard(2)), kv_to.append(Shard(2) if kv % n == 0 else Replicate())
        else:
            q_to.append(Replicate()), kv_to.append(Replicate())
        mask_to.append(Replicate())
    lo = hi = None
    if head_dim_of is not None and not isinstance(kv_to[head_dim_of], Shard):
        # k / v whole over the head dim: the heads this rank's q heads read
        group, q_heads = h // kv, h // mesh.size(head_dim_of)
        first = mesh.get_local_rank(head_dim_of) * q_heads
        lo, hi = first // group, (first + q_heads - 1) // group + 1
        if q_heads % (hi - lo):
            raise ValueError(f"{q_heads} q heads per rank do not group over {hi - lo} kv heads")

    def attend(q_l, k_l, v_l, mask_l):
        if lo is not None:
            k_l, v_l = k_l[:, :, lo:hi], v_l[:, :, lo:hi]
        return _sdpa(q_l, k_l, v_l, mask_l, scale)

    return layers.on_shards(attend, mesh, [(q, q_to), (k, kv_to), (v, kv_to), (mask, mask_to)],
                            [q_to])


def blocked_sdpa(q: Tensor, k: Tensor, v: Tensor, mask, scale: float,
                 block: int = 512, window: int | None = None) -> Tensor:
    """Flash-style blocked attention in plain torch: an online softmax over
    kv blocks inside each q block, never the whole ``[S, T]`` logits or mask.

    ``mask`` is accepted for ``_sdpa``'s signature and ignored: masking is
    structural (causal, plus ``window`` when given). The running max starts
    at the finite sentinel -1e30 (not -inf), so a block with no kept key
    leaves the statistics finite. The last q and kv blocks are partial where
    the reference pads: padded keys are masked and padded rows dropped there,
    so the kept arithmetic is the same.
    """
    del mask
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    group = h // kv
    f32 = torch.float32
    qs = (q.reshape(b, s, kv, group, hd) * scale).to(f32)
    vd = v.shape[-1]
    out = torch.empty((b, s, kv, group, vd), dtype=f32, device=q.device)
    for q0 in range(0, s, block):
        qblk = qs[:, q0:q0 + block]
        bq = qblk.shape[1]
        q_pos = torch.arange(q0, q0 + bq, device=q.device)[:, None]
        m_run = torch.full((b, kv, group, bq), -1e30, dtype=f32, device=q.device)
        l_run = torch.zeros((b, kv, group, bq), dtype=f32, device=q.device)
        acc = torch.zeros((b, kv, group, bq, vd), dtype=f32, device=q.device)
        for k0 in range(0, t, block):
            kblk, vblk = k[:, k0:k0 + block].to(f32), v[:, k0:k0 + block].to(f32)
            k_pos = torch.arange(k0, k0 + kblk.shape[1], device=q.device)[None, :]
            valid = k_pos <= q_pos
            if window is not None:
                valid = valid & (k_pos > q_pos - window)
            logits = torch.einsum("bskgd,btkd->bkgst", qblk, kblk)
            logits = torch.where(valid, logits, -1e30)
            m_new = torch.maximum(m_run, logits.amax(dim=-1))
            p = torch.where(valid, torch.exp(logits - m_new[..., None]), 0.0)
            alpha = torch.exp(m_run - m_new)
            l_run = alpha * l_run + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgst,btkd->bkgsd", p, vblk)
            m_run = m_new
        blk = acc / torch.clamp(l_run, min=1e-30)[..., None]        # [b, kv, g, bq, hd]
        out[:, q0:q0 + bq] = blk.permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, h, vd).to(q.dtype)


def make_blocked_impl(window: int | None = None, block: int = 512):
    """``attn_impl`` factory for the blocked (flash-style) plain path."""
    def impl(q, k, v, mask, scale):
        return blocked_sdpa(q, k, v, mask, scale, block=block, window=window)
    return impl


def _positions(b: int, s: int, device) -> Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def _attend_causal(q: Tensor, k: Tensor, v: Tensor, cfg: ArchConfig,
                   window: int | None, attn_impl) -> Tensor:
    scale = cfg.head_dim ** -0.5
    if attn_impl is not None:
        return attn_impl(q, k, v, None, scale)
    s = q.shape[1]
    win = window if window is not None else cfg.sliding_window
    return _sdpa(q, k, v, layers.causal_mask(s, s, 0, win, device=q.device), scale)


def _project_mla(p: dict, x: Tensor, cfg: ArchConfig, positions: Tensor):
    """Latent attention's q / k / v (module docstring): q and k ``[B, S, H,
    head_dim]``, v ``[B, S, H, value_dim]``."""
    b, s, _ = x.shape
    h, rope, r, vd = cfg.num_heads, cfg.qk_rope_dim, cfg.kv_lora_rank, cfg.value_dim
    nope = cfg.head_dim - rope
    q_nope, q_pe = layers.split_heads(x @ p["wq"], h, nope + rope).split([nope, rope], -1)
    c, k_pe = (x @ p["wkv_a"]).split([r, rope], -1)
    c = layers.rms_norm(c, p["kv_norm"], cfg.norm_eps)
    k_nope, v = layers.split_heads(c @ p["wkv_b"], h, nope + vd).split([nope, vd], -1)
    cos, sin = layers.rotary_cos_sin(positions, rope, cfg.rope_theta)
    q_pe = layers.apply_rotary_interleaved(q_pe, cos, sin)
    k_pe = layers.apply_rotary_interleaved(k_pe[:, :, None], cos, sin)      # one head
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, k_pe.expand(b, s, h, rope)], -1)
    return q, k, v


def attention(p: dict, x: Tensor, cfg: ArchConfig, *,
              positions: Tensor | None = None,
              window: int | None = None,
              attn_impl=None) -> Tensor:
    """Full-sequence causal attention (train / prefill), latent attention
    where ``cfg.is_mla``.

    ``attn_impl``: optional drop-in kernel with the ``_sdpa`` signature (the
    flash kernel's adapter; it is handed ``None`` as the mask) — defaults to
    the plain ``_sdpa``.
    """
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(b, s, x.device)
    project = _project_mla if cfg.is_mla else _project_qkv
    q, k, v = project(p, x, cfg, positions)
    out = _attend_causal(q, k, v, cfg, window, attn_impl)
    return out.reshape(b, s, -1) @ p["wo"]


def attention_prefill(p: dict, x: Tensor, cfg: ArchConfig, *,
                      window: int | None = None,
                      attn_impl=None) -> tuple[Tensor, Tensor, Tensor]:
    """Like ``attention()`` but also returns the rotary-applied (k, v) for
    cache construction. k/v: [B, S, KV, hd]."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, _positions(b, s, x.device))
    out = _attend_causal(q, k, v, cfg, window, attn_impl)
    return out.reshape(b, s, -1) @ p["wo"], k, v


class KVCache(NamedTuple):
    k: Tensor        # [B, T_max, KV, hd]
    v: Tensor        # [B, T_max, KV, hd]
    length: Tensor   # int32, 0-d — tokens already in the cache


def init_cache(batch: int, max_len: int, cfg: ArchConfig, dtype=torch.bfloat16,
               device=None) -> KVCache:
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return KVCache(
        k=torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def decode_attention(p: dict, x: Tensor, cache: KVCache, cfg: ArchConfig, *,
                     window: int | None = None) -> tuple[Tensor, KVCache]:
    """One-token decode: x [B, 1, d]; returns (out [B, 1, d], updated cache).

    The cache is a ring buffer when ``window`` is set and ``T_max <= window``
    (sliding-window decode): slot = length mod T_max. Otherwise the slot is
    ``min(length, T_max - 1)``. The new k/v are written into ``cache`` in
    place.
    """
    b = x.shape[0]
    t_max = cache.k.shape[1]
    pos = cache.length.reshape(1, 1).expand(b, 1)   # [B, 1] absolute position
    q, k_new, v_new = _project_qkv(p, x, cfg, pos)

    win = window if window is not None else cfg.sliding_window
    ring = win is not None and t_max <= win
    if ring:
        slot = torch.remainder(cache.length, t_max)
    else:
        slot = torch.clamp(cache.length, max=t_max - 1)
    index = slot.reshape(1).long()
    layers.write_slot(cache.k, index, k_new.to(cache.k.dtype))
    layers.write_slot(cache.v, index, v_new.to(cache.v.dtype))

    # valid = slots actually written (and inside the window)
    idx = torch.arange(t_max, device=x.device)
    if ring:
        valid = idx < torch.clamp(cache.length + 1, max=t_max)
    else:
        valid = idx <= slot
        if win is not None:
            valid = valid & (idx > slot - win)
    mask = valid[None, :]   # [1 (q), T]

    out = _sdpa(q, cache.k, cache.v, mask, cfg.head_dim ** -0.5)
    # the [B, H*hd] x [H*hd, d] product that matmul folds [B, 1, H*hd] into,
    # written out: a DTensor's matmul would not fold it (and broadcast W_o
    # over B instead, summing in another order)
    out = (out.reshape(b, -1) @ p["wo"]).reshape(b, 1, -1)
    return out, KVCache(k=cache.k, v=cache.v, length=cache.length + 1)
