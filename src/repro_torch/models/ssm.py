"""Selective SSM (Mamba-style) branch of the Hymba hybrid block
(arXiv:2411.13676): depthwise causal conv and a data-dependent (selective)
state-space recurrence; chunked and exact for a sequence, O(1) state for
decode.

Counterpart of ``repro.models.ssm`` (same names, parameter tree and
layouts). Per channel d and state dim n (``cfg.ssm_state`` = N):

    h_t[d, n] = exp(dt_t[d] A[d, n]) h_{t-1}[d, n] + dt_t[d] B_t[n] x_t[d]
    y_t[d]    = sum_n C_t[n] h_t[d, n] + D[d] x_t[d]

A sequence is walked in chunks (a Python loop where the reference runs
``lax.scan``). Inside a chunk the recurrence is solved by a Hillis–Steele
doubling over the time axis, log2(C) steps of whole-tensor ops on the
reference's ``combine`` ``(da, ua), (db, ub) -> (da db, db ua + ub)``: exact
like the reference's ``associative_scan`` (another tree of the same
products), with no inverse decay factor, which overflows. The selective
terms ``[B, C, d, N]`` are built per chunk, so a prefill never holds them
for the whole sequence; the last chunk is partial where the reference pads
it (a padded step keeps the state; its output is dropped).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import layers

Tensor = torch.Tensor

CONV_K = 4      # depthwise causal conv width (mamba default)
DT_RANK_DIV = 16


def init_ssm(generator: torch.Generator, cfg: ArchConfig, device=None,
             num_layers: int | None = None) -> dict:
    """One layer's SSM weights, or ``num_layers`` stacked on ``[L, ...]``
    (d_inner == d_model for the hybrid branch)."""
    d, n = cfg.d_model, cfg.ssm_state
    dt_rank = max(1, d // DT_RANK_DIV)
    device = generator.device if device is None else device
    lead = () if num_layers is None else (num_layers,)

    def draw(shape, scale):
        return layers.init_linear(generator, lead + shape, scale=scale, device=device)

    def const(value, *shape):
        return torch.full(lead + shape, value, dtype=torch.float32, device=device)

    log_a = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
    return {
        "in_proj": draw((d, 2 * d), d ** -0.5),                 # x and the gate z
        "conv_w": draw((CONV_K, d), 0.1),
        "conv_b": const(0.0, d),
        "x_proj": draw((d, dt_rank + 2 * n), d ** -0.5),
        "dt_proj": draw((dt_rank, d), dt_rank ** -0.5),
        "dt_bias": const(math.log(math.expm1(0.01)), d),       # softplus^-1(0.01)
        "log_a": log_a.expand(lead + (d, n)).clone(),
        "d_skip": const(1.0, d),
        "out_proj": draw((d, d), d ** -0.5),
    }


def _causal_conv(x: Tensor, w: Tensor, b: Tensor, state: Tensor) -> tuple[Tensor, Tensor]:
    """Depthwise causal conv1d. x: [B, S, d]; state: [B, K-1, d] (left context).
    Returns (out, the new left context)."""
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(CONV_K))
    return out + b, xp[:, -(CONV_K - 1):, :]


def _selective_terms(p: dict, x: Tensor, cfg: ArchConfig):
    """(log decay [B, S, d, N], input u [B, S, d, N], C_t [B, S, N])."""
    n = cfg.ssm_state
    dt_rank = p["dt_proj"].shape[0]
    # x_proj contracts the channels a mesh shards (d_inner channel-parallel):
    # on DTensors the partial sums are reduced here, before they are sliced
    proj = layers.whole_last_dim(x @ p["x_proj"])
    dt = F.softplus(proj[..., :dt_rank] @ p["dt_proj"] + p["dt_bias"])   # [B, S, d]
    bmat = proj[..., dt_rank:dt_rank + n]                                 # [B, S, N]
    cmat = proj[..., dt_rank + n:]                                        # [B, S, N]
    a = -torch.exp(p["log_a"])                                            # [d, N]
    log_decay = dt[..., None] * a                                         # [B, S, d, N]
    u = (dt * x)[..., None] * bmat[..., None, :]                          # [B, S, d, N]
    return log_decay, u, cmat


def _scan_chunk(h0: Tensor, log_decay: Tensor, u: Tensor) -> tuple[Tensor, Tensor]:
    """The exact in-chunk recurrence: an inclusive scan over time (axis 1) by
    doubling. h0: [B, d, N]; log_decay / u: [B, C, d, N]. Returns
    (h_all [B, C, d, N], h_last)."""
    decay = torch.exp(log_decay)
    h = u.clone()
    h[:, 0] += decay[:, 0] * h0          # fold the carried state into the first input
    c = h.shape[1]
    off = 1
    while off < c:
        # step t combines with t - off: (d_{t-off} d_t, d_t h_{t-off} + h_t)
        h = torch.cat([h[:, :off], torch.addcmul(h[:, off:], decay[:, off:], h[:, :-off])], 1)
        if 2 * off < c:
            decay = torch.cat([decay[:, :off], decay[:, :-off] * decay[:, off:]], 1)
        off *= 2
    return h, h[:, -1]


def ssm_forward(p: dict, x: Tensor, cfg: ArchConfig, state: dict | None = None,
                chunk: int = 128) -> tuple[Tensor, dict]:
    """Full-sequence selective SSM. x: [B, S, d]; ``state`` carries
    {conv [B, K-1, d], h [B, d, N] (f32)}."""
    b, s, d = x.shape
    if state is None:
        state = {"conv": torch.zeros((b, CONV_K - 1, d), dtype=x.dtype, device=x.device),
                 "h": torch.zeros((b, d, cfg.ssm_state), dtype=torch.float32,
                                  device=x.device)}

    xs, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xs, conv_state = _causal_conv(xs, p["conv_w"], p["conv_b"], state["conv"])
    xs = F.silu(xs)

    h, ys = state["h"], []
    for c0 in range(0, s, chunk):
        log_decay, u, cmat = _selective_terms(p, xs[:, c0:c0 + chunk], cfg)
        h_all, h = _scan_chunk(h, log_decay.to(torch.float32), u.to(torch.float32))
        ys.append(torch.einsum("bsdn,bsn->bsd", h_all, cmat.to(torch.float32)))
    y = torch.cat(ys, dim=1).to(x.dtype) + p["d_skip"] * xs
    out = (y * F.silu(z)) @ p["out_proj"]
    return out, {"conv": conv_state, "h": h}


def ssm_decode(p: dict, x: Tensor, cfg: ArchConfig, state: dict) -> tuple[Tensor, dict]:
    """One step. x: [B, 1, d]; returns (out [B, 1, d], new state)."""
    xs, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xs, conv_state = _causal_conv(xs, p["conv_w"], p["conv_b"], state["conv"])
    xs = F.silu(xs)

    log_decay, u, cmat = _selective_terms(p, xs, cfg)
    h = (torch.exp(log_decay[:, 0].to(torch.float32)) * state["h"]
         + u[:, 0].to(torch.float32))
    y = torch.einsum("bdn,bn->bd", h, cmat[:, 0].to(torch.float32))[:, None, :]
    y = y.to(x.dtype) + p["d_skip"] * xs
    out = (y * F.silu(z)) @ p["out_proj"]
    return out, {"conv": conv_state, "h": h}
