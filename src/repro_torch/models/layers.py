"""Shared transformer building blocks: plain functions on tensors.

Counterpart of ``repro.models.layers`` with the same names, arguments and
layouts (``[d_in, d_out]`` weights, ``[..., S, H, hd]`` heads). Norms and
rotary embeddings compute in f32 and cast back to the input's dtype, as the
reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def rms_norm(x: Tensor, weight: Tensor, eps: float = 1e-6) -> Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * weight.to(torch.float32)
    return out.to(dtype)


def layer_norm(x: Tensor, weight: Tensor, bias: Tensor, eps: float = 1e-5) -> Tensor:
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


def swiglu(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor) -> Tensor:
    """SwiGLU MLP: down( silu(x @ gate) * (x @ up) )."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: Tensor, w_up: Tensor, b_up: Tensor, w_down: Tensor,
             b_down: Tensor) -> Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ w_up + b_up, approximate="tanh") @ w_down + b_down


def embed(tokens: Tensor, table: Tensor) -> Tensor:
    return table[tokens.long()]


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
