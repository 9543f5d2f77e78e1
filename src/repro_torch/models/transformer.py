"""Decoder assembly, dense family: pre-norm GQA attention + pre-norm SwiGLU MLP.

Counterpart of ``repro.models.transformer`` for ``family == "dense"``
(qwen3-1.7b, qwen2.5-3b, qwen1.5-4b, granite-34b). Per-layer parameters are
stacked on a leading ``[L, ...]`` axis as in the reference, so weights
convert leaf by leaf (``convert.transformer_params_from_numpy``); the layer
stack is a Python loop where the reference runs ``lax.scan``.

The other families raise ``NotImplementedError`` naming the module they
wait for (MoE ``models/moe.py``, rwkv6 ``models/rwkv6.py``, hybrid
``models/ssm.py``, VLM / audio prefixes ``models/multimodal.py``).
``forward_with_aux`` / ``lm_loss`` belong to the training slice.

``decode_step`` writes each layer's new k/v into ``state.kv`` in place (see
``attention.decode_attention``); the returned state shares its tensors.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..configs.base import ArchConfig
from . import attention, layers

Tensor = torch.Tensor

_LATER = {"moe": "models/moe.py", "ssm": "models/rwkv6.py", "hybrid": "models/ssm.py",
          "vlm": "models/multimodal.py", "audio": "models/multimodal.py",
          "cnn": "fed/simulator (the paper's CNNs train there, not in a decoder)"}


def check_dense(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` is a dense decoder, the family this slice ports."""
    if cfg.is_moe:
        family = "moe"
    elif cfg.hybrid:
        family = "hybrid"
    elif cfg.embed_input:
        family = cfg.family if cfg.family in ("vlm", "audio") else "vlm"
    else:
        family = cfg.family
    if family == "dense":
        return
    raise NotImplementedError(
        f"{cfg.name}: family {family!r} needs {_LATER.get(family, 'its own module')}; "
        "repro_torch's transformer ports the dense family only")


# ------------------------------------------------------------- init ---------

def init_params(generator: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
                device=None) -> dict:
    """Random weights drawn from ``generator`` on ``device`` (the generator's
    device when not given): the reference's tree and layouts — ``embed``
    ``[V, d]``, ``blocks`` with ``[L, ...]`` leaves, ``final_norm``, and
    ``lm_head`` ``[d, V]`` unless embeddings are tied."""
    check_dense(cfg)
    device = generator.device if device is None else device
    L, d = cfg.num_layers, cfg.d_model

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    def linear(d_in, d_out):
        return layers.init_linear(generator, (L, d_in, d_out), scale=d_in ** -0.5,
                                  device=device)

    blocks = {
        "norm1": ones(L, d), "norm2": ones(L, d),
        "attn": attention.init_attn(generator, cfg, device=device, num_layers=L),
        "mlp": {"w_gate": linear(d, cfg.d_ff), "w_up": linear(d, cfg.d_ff),
                "w_down": linear(cfg.d_ff, d)},
    }
    params = {
        "embed": 0.02 * torch.randn((cfg.vocab_size, d), generator=generator,
                                    dtype=torch.float32, device=device),
        "blocks": blocks,
        "final_norm": ones(d),
    }
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


def _head(params: dict, cfg: ArchConfig) -> Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _mlp(p: dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    h = layers.rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + layers.swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"])


# --------------------------------------------------------- forward ----------

def forward(params: dict, tokens: Tensor, cfg: ArchConfig, *,
            window: int | None = None, attn_impl=None) -> Tensor:
    """Train / prefill forward: tokens [B, S] -> logits [B, S, V]."""
    check_dense(cfg)
    x = layers.embed(tokens, params["embed"])
    for i in range(cfg.num_layers):
        p = layer_params(params["blocks"], i)
        h = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + attention.attention(p["attn"], h, cfg, window=window, attn_impl=attn_impl)
        x = _mlp(p, x, cfg)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return layers.unembed(x, _head(params, cfg), cfg.true_vocab_size)


# ---------------------------------------------------------- prefill ---------

def _block_prefill(p: dict, x: Tensor, cfg: ArchConfig, *, window: int | None,
                   attn_impl=None) -> tuple[Tensor, Tensor, Tensor]:
    """Full-sequence block that also returns the layer's cache entries: the
    whole sequence, or the last ``win`` positions rolled into ring order."""
    s = x.shape[1]
    h = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
    win = window if window is not None else cfg.sliding_window
    a, k, v = attention.attention_prefill(p["attn"], h, cfg, window=win,
                                          attn_impl=attn_impl)
    x = x + a
    if win is not None and s > win:
        r = s % win
        k = torch.roll(k[:, s - win:], r, dims=1)
        v = torch.roll(v[:, s - win:], r, dims=1)
    return _mlp(p, x, cfg), k, v


def prefill(params: dict, tokens: Tensor, cfg: ArchConfig, *,
            window: int | None = None, attn_impl=None,
            cache_dtype=torch.bfloat16) -> tuple[Tensor, "DecodeState"]:
    """Prefill: returns (last-position logits [B, V], DecodeState)."""
    check_dense(cfg)
    x = layers.embed(tokens, params["embed"])
    s = tokens.shape[1]
    L = cfg.num_layers
    cache_k = cache_v = None
    for i in range(L):
        x, k, v = _block_prefill(layer_params(params["blocks"], i), x, cfg,
                                 window=window, attn_impl=attn_impl)
        if cache_k is None:   # one [L, ...] buffer, filled layer by layer
            cache_k = torch.empty((L,) + tuple(k.shape), dtype=cache_dtype, device=k.device)
            cache_v = torch.empty_like(cache_k)
        cache_k[i] = k
        cache_v[i] = v
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    last_logits = layers.unembed(x[:, -1], _head(params, cfg), cfg.true_vocab_size)
    kv = attention.KVCache(k=cache_k, v=cache_v,
                           length=torch.full((L,), s, dtype=torch.int32, device=x.device))
    return last_logits, DecodeState(kv=kv, rwkv=None, ssm=None,
                                    position=torch.tensor(s, dtype=torch.int32,
                                                          device=x.device))


# ----------------------------------------------------------- decode ---------

class DecodeState(NamedTuple):
    """Per-layer recurrent state stacked on a leading [L, ...] axis. ``rwkv``
    and ``ssm`` are None for the dense family (kept for the reference's
    structure)."""
    kv: Any          # attention.KVCache, leaves [L, B, T, KV, hd] and length [L]
    rwkv: Any
    ssm: Any
    position: Tensor  # int32, 0-d


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      cache_dtype=torch.bfloat16, device=None) -> DecodeState:
    check_dense(cfg)
    L = cfg.num_layers
    eff_len = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (L, batch, eff_len, cfg.num_kv_heads, cfg.head_dim)
    kv = attention.KVCache(
        k=torch.zeros(shape, dtype=cache_dtype, device=device),
        v=torch.zeros(shape, dtype=cache_dtype, device=device),
        length=torch.zeros((L,), dtype=torch.int32, device=device))
    return DecodeState(kv=kv, rwkv=None, ssm=None,
                       position=torch.zeros((), dtype=torch.int32, device=device))


def _block_decode(p: dict, x: Tensor, cfg: ArchConfig,
                  cache: attention.KVCache) -> tuple[Tensor, attention.KVCache]:
    h = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
    # no window here, as in the reference (transformer.py's _block_decode):
    # only cfg.sliding_window reaches decode_attention
    a, cache = attention.decode_attention(p["attn"], h, cache, cfg)
    return _mlp(p, x + a, cfg), cache


def decode_step(params: dict, tokens: Tensor, state: DecodeState,
                cfg: ArchConfig) -> tuple[Tensor, DecodeState]:
    """One decode step: tokens [B, 1] -> logits [B, V], updated state (its
    cache tensors are ``state``'s, written in place)."""
    check_dense(cfg)
    x = layers.embed(tokens, params["embed"])
    for i in range(cfg.num_layers):
        cache = attention.KVCache(k=state.kv.k[i], v=state.kv.v[i],
                                  length=state.kv.length[i])
        x, _ = _block_decode(layer_params(params["blocks"], i), x, cfg, cache)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.unembed(x[:, 0], _head(params, cfg), cfg.true_vocab_size)
    kv = attention.KVCache(k=state.kv.k, v=state.kv.v, length=state.kv.length + 1)
    return logits, DecodeState(kv=kv, rwkv=None, ssm=None, position=state.position + 1)
