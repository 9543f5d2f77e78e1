"""Decoder assembly for every architecture family of the registry.

Counterpart of ``repro.models.transformer``. Families:

  dense / vlm / audio : pre-norm GQA attention + pre-norm SwiGLU MLP
  moe                 : pre-norm GQA attention + pre-norm MoE FFN (``models/moe``);
                        deepseek_v3 (port-only, training): latent attention
                        (``attention``, ``cfg.is_mla``), ``first_dense_layers``
                        leading SwiGLU layers on their own ``dense_blocks``
                        stack before the MoE ``blocks``, shared experts
  ssm (rwkv6)         : time-mix + channel-mix, LayerNorm with bias, token shift
                        (``models/rwkv6``)
  hybrid (hymba)      : parallel {attention, selective SSM} branches, each
                        ``rms_norm``ed, averaged; + SwiGLU MLP (``models/ssm``)

VLM / audio take ``prefix_embeds [B, P, d]`` (the frontend stub's output,
``models/multimodal``), put before the token embeddings: logits are
``[B, P + S, V]`` and the prefix holds positions 0..P-1 of the causal
structure and of the rotary phases.

Per-layer parameters are stacked on a leading ``[L, ...]`` axis as in the
reference, so weights convert leaf by leaf
(``convert.transformer_params_from_numpy``); the layer stack is a Python
loop where the reference runs ``lax.scan``. ``forward_with_aux`` also returns
the sum of the layers' MoE load-balance losses (0 for the other families) and
``lm_loss`` is the training objective built on it; ``forward`` drops the aux
loss, as the reference's does. ``remat=True`` recomputes each block in the
backward pass (``torch.utils.checkpoint``, the twin of ``jax.checkpoint``).
A ``PhaseTimer`` passed to ``forward_with_aux`` / ``lm_loss`` brackets each
block's latent attention (span ``mla``) and MoE (``moe``); under remat they
open again in the recompute.

``decode_step`` updates ``state`` in place: each layer's new k/v are written
into ``state.kv`` (see ``attention.decode_attention``) and the recurrent
states ``state.rwkv`` / ``state.ssm`` are overwritten with the step's; the
returned state shares every tensor with ``state`` but ``position`` and the
cache ``length``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..profiling import PhaseTimer, phase
from . import attention, layers, moe, rwkv6, ssm

Tensor = torch.Tensor


# ------------------------------------------------------------- init ---------

def init_params(generator: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
                device=None) -> dict:
    """Random weights drawn from ``generator`` on ``device`` (the generator's
    device when not given): the reference's tree and layouts — ``embed``
    ``[V, d]``, ``blocks`` with ``[L, ...]`` leaves, ``final_norm`` (and
    ``final_norm_b`` for rwkv6), and ``lm_head`` ``[d, V]`` unless embeddings
    are tied; with ``first_dense_layers`` L0, ``dense_blocks`` (``[L0, ...]``
    leaves, a SwiGLU of width ``dense_d_ff``) and ``blocks`` of ``L - L0``."""
    device = generator.device if device is None else device
    L0, d = cfg.first_dense_layers, cfg.d_model
    L = cfg.num_layers - L0

    def const(value, *shape):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    def linear(d_in, d_out, n=L):
        return layers.init_linear(generator, (n, d_in, d_out), scale=d_in ** -0.5,
                                  device=device)

    dense_blocks = None
    if L0:
        f = cfg.dense_d_ff
        dense_blocks = {"norm1": const(1.0, L0, d), "norm2": const(1.0, L0, d),
                        "attn": attention.init_attn(generator, cfg, device=device, num_layers=L0),
                        "mlp": {"w_gate": linear(d, f, L0), "w_up": linear(d, f, L0),
                                "w_down": linear(f, d, L0)}}

    blocks = {"norm1": const(1.0, L, d), "norm2": const(1.0, L, d)}
    if cfg.family == "ssm":   # rwkv6: LayerNorm has a bias
        blocks["norm1_b"], blocks["norm2_b"] = const(0.0, L, d), const(0.0, L, d)
        blocks["time_mix"] = rwkv6.init_time_mix(generator, cfg, device, num_layers=L)
        blocks["channel_mix"] = rwkv6.init_channel_mix(generator, cfg, device, num_layers=L)
    else:
        blocks["attn"] = attention.init_attn(generator, cfg, device=device, num_layers=L)
        if cfg.hybrid:
            blocks["ssm"] = ssm.init_ssm(generator, cfg, device, num_layers=L)
            blocks["branch_norm_attn"] = const(1.0, L, d)
            blocks["branch_norm_ssm"] = const(1.0, L, d)
        if cfg.is_moe:
            blocks["moe"] = moe.init_moe(generator, cfg, device, num_layers=L)
        else:
            blocks["mlp"] = {"w_gate": linear(d, cfg.d_ff), "w_up": linear(d, cfg.d_ff),
                             "w_down": linear(cfg.d_ff, d)}
    params = {
        "embed": 0.02 * torch.randn((cfg.vocab_size, d), generator=generator,
                                    dtype=torch.float32, device=device),
        "blocks": blocks,
        "final_norm": const(1.0, d),
    }
    if dense_blocks is not None:
        params["dense_blocks"] = dense_blocks
    if cfg.family == "ssm":
        params["final_norm_b"] = const(0.0, d)
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.init_linear(generator, (d, cfg.vocab_size), scale=0.02,
                                               device=device)
    return _tree_map(lambda x: x.to(dtype), params)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {name: _tree_map(fn, v) for name, v in tree.items()}
    return fn(tree)


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i``'s parameters: index ``i`` of every stacked leaf (views)."""
    return _tree_map(lambda x: x[i], blocks)


def _stacks(params: dict, cfg: ArchConfig) -> list[tuple[dict, int, bool]]:
    """The layer stacks in order: (tree, layers, whether its FFN is the
    dense MLP of the leading dense layers)."""
    L0 = cfg.first_dense_layers
    lead = [(params["dense_blocks"], L0, True)] if L0 else []
    return lead + [(params["blocks"], cfg.num_layers - L0, False)]


def _serves(cfg: ArchConfig) -> None:
    if cfg.first_dense_layers or cfg.is_mla:
        raise NotImplementedError(f"{cfg.name} trains only: serving waits for a latent KV "
                                  "cache")


def _embed(params: dict, tokens: Tensor, prefix_embeds: Tensor | None) -> Tensor:
    x = layers.embed(tokens, params["embed"])
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def _logits(params: dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    if cfg.family == "ssm":
        x = layers.layer_norm(x, params["final_norm"], params["final_norm_b"], cfg.norm_eps)
    else:
        x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return layers.unembed(x, head, cfg.true_vocab_size)


def _ffn(p: dict, x: Tensor, cfg: ArchConfig, timer: PhaseTimer | None = None,
         dense: bool = False) -> tuple[Tensor, Tensor | None]:
    """The second half of an attention-family block: pre-norm MLP or MoE
    (``dense``: a leading dense layer's MLP). Returns (x, the MoE aux loss;
    None for an MLP)."""
    h = layers.rms_norm(x, p["norm2"], cfg.norm_eps)
    if cfg.is_moe and not dense:
        with phase(timer, "moe"):
            out, aux = moe.moe_ffn(p["moe"], h, cfg, timer)
        return x + out, aux
    return x + layers.swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"]), None


def _mix_branches(p: dict, a: Tensor, s: Tensor, cfg: ArchConfig) -> Tensor:
    """The hybrid block's average of the two ``rms_norm``ed branches."""
    return 0.5 * (layers.rms_norm(a, p["branch_norm_attn"], cfg.norm_eps)
                  + layers.rms_norm(s, p["branch_norm_ssm"], cfg.norm_eps))


def _rwkv_block(p: dict, x: Tensor, cfg: ArchConfig, time_mix, cm_shift: Tensor):
    """An rwkv6 block around ``time_mix(h) -> (out, {shift, wkv})``. Returns
    (x, the block's recurrent state)."""
    h = layers.layer_norm(x, p["norm1"], p["norm1_b"], cfg.norm_eps)
    tm, tm_state = time_mix(h)
    x = x + tm
    h = layers.layer_norm(x, p["norm2"], p["norm2_b"], cfg.norm_eps)
    cm, cm_shift = rwkv6.channel_mix(p["channel_mix"], h, cm_shift)
    return x + cm, {"shift": tm_state["shift"], "wkv": tm_state["wkv"], "cm_shift": cm_shift}


# --------------------------------------------------------- forward ----------

def _block_forward(p: dict, x: Tensor, cfg: ArchConfig, window: int | None,
                   attn_impl, timer: PhaseTimer | None = None,
                   dense: bool = False) -> tuple[Tensor, Tensor | None]:
    """Full-sequence block. Returns (x, the layer's MoE aux loss or None)."""
    if cfg.family == "ssm":
        x, _ = _rwkv_block(p, x, cfg, lambda h: rwkv6.time_mix(p["time_mix"], h, cfg),
                           torch.zeros_like(x[:, 0]))
        return x, None
    h = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
    with phase(timer if cfg.is_mla else None, "mla"):
        a = attention.attention(p["attn"], h, cfg, window=window, attn_impl=attn_impl)
    if cfg.hybrid:
        s, _ = ssm.ssm_forward(p["ssm"], h, cfg)
        a = _mix_branches(p, a, s, cfg)
    return _ffn(p, x + a, cfg, timer, dense)


def forward_with_aux(params: dict, tokens: Tensor, cfg: ArchConfig, *,
                     prefix_embeds: Tensor | None = None, window: int | None = None,
                     attn_impl=None, remat: bool = False,
                     timer: PhaseTimer | None = None) -> tuple[Tensor, Tensor]:
    """Train / prefill forward: tokens [B, S] -> (logits [B, P + S, V], the
    layers' summed MoE aux loss, an f32 0-d tensor: 0 for the other
    families)."""
    x = _embed(params, tokens, prefix_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blocks, n, dense in _stacks(params, cfg):
        for i in range(n):
            p = layer_params(blocks, i)
            if remat:
                x, aux_l = checkpoint(_block_forward, p, x, cfg, window, attn_impl, timer,
                                      dense, use_reentrant=False)
            else:
                x, aux_l = _block_forward(p, x, cfg, window, attn_impl, timer, dense)
            if aux_l is not None:
                aux = aux + aux_l
    return _logits(params, x, cfg), aux


def forward(params: dict, tokens: Tensor, cfg: ArchConfig, *,
            prefix_embeds: Tensor | None = None, window: int | None = None,
            attn_impl=None, remat: bool = False) -> Tensor:
    """Train / prefill forward: tokens [B, S] -> logits [B, P + S, V]."""
    return forward_with_aux(params, tokens, cfg, prefix_embeds=prefix_embeds, window=window,
                            attn_impl=attn_impl, remat=remat)[0]


# ---------------------------------------------------------- prefill ---------

def _block_prefill(p: dict, x: Tensor, cfg: ArchConfig, *, window: int | None,
                   attn_impl=None) -> tuple[Tensor, dict]:
    """Full-sequence block that also returns the layer's decode state: ``kv``
    (k, v — the whole sequence, or the last ``win`` positions rolled into ring
    order), ``rwkv`` or ``ssm``."""
    if cfg.family == "ssm":
        x, rk = _rwkv_block(p, x, cfg, lambda h: rwkv6.time_mix(p["time_mix"], h, cfg),
                            torch.zeros_like(x[:, 0]))
        return x, {"rwkv": rk}
    s = x.shape[1]
    state = {}
    h = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
    win = window if window is not None else cfg.sliding_window
    a, k, v = attention.attention_prefill(p["attn"], h, cfg, window=win,
                                          attn_impl=attn_impl)
    if cfg.hybrid:
        sout, state["ssm"] = ssm.ssm_forward(p["ssm"], h, cfg)
        a = _mix_branches(p, a, sout, cfg)
    if win is not None and s > win:
        r = s % win
        k = layers.roll(k[:, s - win:], r, dim=1)
        v = layers.roll(v[:, s - win:], r, dim=1)
    state["kv"] = {"k": k, "v": v}
    return _ffn(p, x + a, cfg)[0], state


def _stack_into(stacked: dict | None, i: int, L: int, leaves: dict, dtype=None) -> dict:
    """Write layer ``i``'s ``leaves`` into ``[L, ...]`` buffers (made at
    layer 0, in ``dtype`` or the leaf's own)."""
    if stacked is None:
        stacked = {name: layers.empty_stack(L, t, dtype) for name, t in leaves.items()}
    for name, t in leaves.items():
        stacked[name][i] = t
    return stacked


def prefill(params: dict, tokens: Tensor, cfg: ArchConfig, *,
            prefix_embeds: Tensor | None = None, window: int | None = None,
            attn_impl=None, cache_dtype=torch.bfloat16) -> tuple[Tensor, "DecodeState"]:
    """Prefill: returns (last-position logits [B, V], DecodeState). The state
    holds ``kv`` (None for rwkv6; leaves ``[L, B, T, KV, hd]`` in
    ``cache_dtype``), ``rwkv`` {shift, wkv, cm_shift} or ``ssm`` {conv, h},
    each stacked on ``[L]``, and ``position`` = P + S."""
    _serves(cfg)
    x = _embed(params, tokens, prefix_embeds)
    s_total, L = x.shape[1], cfg.num_layers
    kv = rk = sm = None
    for i in range(L):
        x, st = _block_prefill(layer_params(params["blocks"], i), x, cfg, window=window,
                               attn_impl=attn_impl)
        if "kv" in st:
            kv = _stack_into(kv, i, L, st["kv"], cache_dtype)
        if "rwkv" in st:
            rk = _stack_into(rk, i, L, st["rwkv"])
        if "ssm" in st:
            sm = _stack_into(sm, i, L, st["ssm"])
    last_logits = _logits(params, x[:, -1], cfg)
    device = x.device
    cache = None if kv is None else attention.KVCache(
        k=kv["k"], v=kv["v"], length=torch.full((L,), s_total, dtype=torch.int32,
                                                device=device))
    return last_logits, DecodeState(kv=cache, rwkv=rk, ssm=sm, position=torch.tensor(
        s_total, dtype=torch.int32, device=device))


# ----------------------------------------------------------- decode ---------

class DecodeState(NamedTuple):
    """Per-layer decode state stacked on a leading [L, ...] axis."""
    kv: Any           # attention.KVCache, leaves [L, B, T, KV, hd] and length [L]; or None
    rwkv: Any         # {"shift" [L,B,d], "wkv" [L,B,H,D,D], "cm_shift" [L,B,d]} or None
    ssm: Any          # {"conv" [L,B,K-1,d], "h" [L,B,d,N]} or None
    position: Tensor  # int32, 0-d: tokens (prefix included) seen so far


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      cache_dtype=torch.bfloat16, device=None) -> DecodeState:
    _serves(cfg)
    L = cfg.num_layers

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    kv = rk = sm = None
    if not cfg.attn_free:
        eff_len = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
        shape = (L, batch, eff_len, cfg.num_kv_heads, cfg.head_dim)
        kv = attention.KVCache(k=zeros(*shape, dtype=cache_dtype),
                               v=zeros(*shape, dtype=cache_dtype),
                               length=zeros(L, dtype=torch.int32))
    if cfg.family == "ssm":
        h = rwkv6.num_heads(cfg)
        rk = {"shift": zeros(L, batch, cfg.d_model),
              "wkv": zeros(L, batch, h, cfg.head_dim, cfg.head_dim),
              "cm_shift": zeros(L, batch, cfg.d_model)}
    if cfg.hybrid:
        sm = {"conv": zeros(L, batch, ssm.CONV_K - 1, cfg.d_model),
              "h": zeros(L, batch, cfg.d_model, cfg.ssm_state)}
    return DecodeState(kv=kv, rwkv=rk, ssm=sm, position=zeros(dtype=torch.int32))


def _layer_state(tree: dict, i: int) -> dict:
    return {name: t[i] for name, t in tree.items()}


def _write_back(tree: dict, i: int, new: dict) -> None:
    for name, t in new.items():
        tree[name][i].copy_(t)


def _block_decode(p: dict, x: Tensor, cfg: ArchConfig, state: DecodeState,
                  i: int) -> Tensor:
    """Layer ``i`` of one decode step; writes the layer's new state into
    ``state`` in place."""
    if cfg.family == "ssm":
        carry = _layer_state(state.rwkv, i)
        x, rk = _rwkv_block(p, x, cfg, lambda h: rwkv6.time_mix_decode(
            p["time_mix"], h, cfg, {"shift": carry["shift"], "wkv": carry["wkv"]}),
            carry["cm_shift"])
        _write_back(state.rwkv, i, rk)
        return x
    h = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
    cache = attention.KVCache(k=state.kv.k[i], v=state.kv.v[i], length=state.kv.length[i])
    # no window here, as in the reference (transformer.py's _block_decode):
    # only cfg.sliding_window reaches decode_attention
    a, _ = attention.decode_attention(p["attn"], h, cache, cfg)
    if cfg.hybrid:
        s, sm = ssm.ssm_decode(p["ssm"], h, cfg, _layer_state(state.ssm, i))
        _write_back(state.ssm, i, sm)
        a = _mix_branches(p, a, s, cfg)
    return _ffn(p, x + a, cfg)[0]


def decode_step(params: dict, tokens: Tensor, state: DecodeState,
                cfg: ArchConfig) -> tuple[Tensor, DecodeState]:
    """One decode step: tokens [B, 1] -> logits [B, V], updated state (its
    tensors are ``state``'s, written in place)."""
    x = layers.embed(tokens, params["embed"])
    for i in range(cfg.num_layers):
        x = _block_decode(layer_params(params["blocks"], i), x, cfg, state, i)
    logits = _logits(params, x[:, 0], cfg)
    kv = None if state.kv is None else state.kv._replace(length=state.kv.length + 1)
    return logits, state._replace(kv=kv, position=state.position + 1)


# ------------------------------------------------------------- loss ---------

def lm_loss(params: dict, tokens: Tensor, cfg: ArchConfig, *,
            prefix_embeds: Tensor | None = None, aux_weight: float | None = None,
            **kw) -> Tensor:
    """Next-token cross-entropy (+ ``aux_weight``, by default
    ``cfg.aux_weight``, x the MoE aux loss of the config's form). Labels are
    the tokens shifted by one; the prefix (frontend) positions are left out
    of the loss. ``kw`` goes to ``forward_with_aux``."""
    aux_weight = cfg.aux_weight if aux_weight is None else aux_weight
    logits, aux = forward_with_aux(params, tokens, cfg, prefix_embeds=prefix_embeds, **kw)
    p = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    logits = logits[:, p:, :]
    ce = layers.cross_entropy(logits[:, :-1], tokens[:, 1:])
    return ce + aux_weight * aux
