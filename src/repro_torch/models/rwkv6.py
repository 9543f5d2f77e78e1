"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free time-mix with
data-dependent decay, and channel-mix. Chunked-parallel sequence form and
O(1) recurrent decode form.

Counterpart of ``repro.models.rwkv6`` (same names, parameter tree and
layouts). Per head (head_dim = D), with receptance r_t, key k_t, value v_t,
decay w_t in (0, 1)^D and per-channel bonus u:

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t          (state, [D, D])
    y_t = r_t @ S_{t-1} + (r_t * u * k_t).sum() v_t

Inside a chunk the pairwise decays are ``exp(L_{t-1} - L_a)`` from cumulative
log-decays, as in the reference. The WKV state and the recurrence stay f32.
The sequence form walks chunks in a Python loop where the reference runs
``lax.scan``; its last chunk is partial where the reference zero-pads it
(a padded step has ``logw = 0`` and ``k = v = 0``: it keeps the state and its
output is dropped, so the kept arithmetic is the same).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import layers

Tensor = torch.Tensor

LORA_R = 32  # low-rank size of the data-dependent decay / mix projections


def num_heads(cfg: ArchConfig) -> int:
    """WKV head count. ``cfg.num_heads`` may exceed d_model / head_dim when
    padded for a mesh; the padded heads are inert (zero ``wo`` rows)."""
    return cfg.num_heads or (cfg.d_model // cfg.head_dim)


def inner_width(cfg: ArchConfig) -> int:
    return num_heads(cfg) * cfg.head_dim


def init_time_mix(generator: torch.Generator, cfg: ArchConfig, device=None,
                  num_layers: int | None = None) -> dict:
    """One layer's time-mix weights, or ``num_layers`` stacked on ``[L, ...]``."""
    d, h, w = cfg.d_model, num_heads(cfg), inner_width(cfg)
    device = generator.device if device is None else device
    lead = () if num_layers is None else (num_layers,)

    def draw(shape, scale):
        return layers.init_linear(generator, lead + shape, scale=scale, device=device)

    def const(value, *shape):
        return torch.full(lead + shape, value, dtype=torch.float32, device=device)

    p = {
        # token-shift interpolation factors for r, k, v, w, g
        "mix_mu": const(0.5, 5, d),
        "mix_w1": draw((d, 5 * LORA_R), 0.01),
        "mix_w2": draw((5, LORA_R, d), 0.01),
        # projections (inner width w = H * head_dim, == d unless heads padded)
        "wr": draw((d, w), d ** -0.5), "wk": draw((d, w), d ** -0.5),
        "wv": draw((d, w), d ** -0.5), "wg": draw((d, w), d ** -0.5),
        "wo": draw((w, d), w ** -0.5),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x w1) w2))
        "decay_w0": const(-6.0, w),
        "decay_w1": draw((d, 2 * LORA_R), 0.01),
        "decay_w2": draw((2 * LORA_R, w), 0.01),
        "bonus_u": draw((h, cfg.head_dim), 0.5),
        "ln_x": const(1.0, w),   # per-head group-norm weight on the output
    }
    true_h = cfg.true_num_heads or (cfg.d_model // cfg.head_dim)
    if true_h < h:   # zero the wo rows of padded heads: padding is inert
        p["wo"][..., true_h * cfg.head_dim:, :] = 0.0
    return p


def init_channel_mix(generator: torch.Generator, cfg: ArchConfig, device=None,
                     num_layers: int | None = None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    device = generator.device if device is None else device
    lead = () if num_layers is None else (num_layers,)

    def draw(shape):
        return layers.init_linear(generator, lead + shape, scale=shape[0] ** -0.5,
                                  device=device)

    half = torch.full(lead + (d,), 0.5, dtype=torch.float32, device=device)
    return {"mix_k": half, "mix_r": half.clone(),
            "wk": draw((d, f)), "wv": draw((f, d)), "wr": draw((d, d))}


def _token_shift(x: Tensor, prev: Tensor) -> Tensor:
    """shift(x)_t = x_{t-1}; position 0 takes ``prev`` (the carried last token)."""
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _ddlerp(p: dict, x: Tensor, xx: Tensor) -> list[Tensor]:
    """RWKV-6's data-dependent interpolation: the 5 mixed inputs r, k, v, w, g."""
    b, s, _ = x.shape
    delta = xx - x
    base = x[:, :, None, :] + delta[:, :, None, :] * p["mix_mu"][None, None]   # [B,S,5,d]
    lora = torch.tanh(((x + 0.5 * delta) @ p["mix_w1"]).reshape(b, s, 5, LORA_R))
    adj = torch.einsum("bsmr,mrd->bsmd", lora, p["mix_w2"])
    mixed = base + delta[:, :, None, :] * adj
    return [mixed[:, :, i, :] for i in range(5)]


def _wkv_chunk(r, k, v, logw, u, state):
    """One chunk of the WKV recurrence, parallel within the chunk.

    r, k, v: [B, C, H, D]; logw: [B, C, H, D] (log decay, <= 0); u: [H, D];
    state: [B, H, D, D]. Returns (y [B, C, H, D], new state).
    """
    c = r.shape[1]
    lw = torch.cumsum(logw, dim=1)                    # L_t = sum_{i<=t} log w_i
    lw_prev = lw - logw                               # L_{t-1}

    # across chunks: y_cross_t = (r_t * exp(L_{t-1})) @ S_0
    r_dec = r * torch.exp(lw_prev)
    y_cross = torch.einsum("bchd,bhde->bche", r_dec, state)

    # within the chunk: pairwise decay exp(L_{t-1} - L_a) for a < t
    att = torch.einsum("bchd,bahd->bhca", r_dec, k * torch.exp(-lw))
    pos = torch.arange(c, device=r.device)
    att = torch.where(pos[None, :] < pos[:, None], att, 0.0)
    # the diagonal bonus term: (r_t * u * k_t) summed over channels
    diag = torch.einsum("bchd,hd,bchd->bhc", r, u, k)
    att = att + torch.diag_embed(diag)
    y_intra = torch.einsum("bhca,bahe->bche", att, v)

    # state: S_C = diag(exp(L_C)) S_0 + sum_a exp(L_C - L_a) k_a (x) v_a
    lw_end = lw[:, -1:]                                # [B, 1, H, D]
    k_dec = k * torch.exp(lw_end - lw)
    new_state = state * torch.exp(lw_end[:, 0])[..., None] + torch.einsum(
        "bahd,bahe->bhde", k_dec, v)
    return y_cross + y_intra, new_state


def _per_head(fn, lead: Tensor, inputs: list, outputs: list):
    """``fn`` of the recurrence's tensors; on DTensors (a mesh's steps), run
    on each rank's shards (``layers.on_shards``): the recurrence is
    independent per batch row and per head. ``inputs`` are (tensor, its batch
    dim or None, its head dim or None), ``outputs`` (batch dim, head dim) of
    ``fn``'s results. The mesh dims that shard ``lead``'s batch dim keep
    sharding every batch dim, those that shard its heads (where they divide
    evenly) every head dim; everything else is gathered."""
    if not any(layers.is_dtensor(x) for x, _, _ in inputs):
        return fn(*(x for x, _, _ in inputs))
    from torch.distributed.tensor import Replicate, Shard

    mesh = next(x for x, _, _ in inputs if layers.is_dtensor(x)).device_mesh
    lead_batch, lead_head = 0, inputs[0][2]
    roles = []
    for m, p in enumerate(lead.placements if layers.is_dtensor(lead)
                          else [Replicate()] * mesh.ndim):
        if isinstance(p, Shard) and p.dim == lead_batch:
            roles.append("batch")
        elif (isinstance(p, Shard) and p.dim == lead_head
              and lead.shape[lead_head] % mesh.size(m) == 0 and "head" not in roles):
            roles.append("head")
        else:
            roles.append(None)

    def to(batch_dim, head_dim):
        return [Shard(batch_dim) if role == "batch" and batch_dim is not None else
                Shard(head_dim) if role == "head" and head_dim is not None else Replicate()
                for role in roles]

    return layers.on_shards(fn, mesh, [(x, to(b, h)) for x, b, h in inputs],
                            [to(b, h) for b, h in outputs])


def _projections(p: dict, x: Tensor, xx: Tensor, cfg: ArchConfig):
    """r, k, v [B, S, H, D], the gate g [B, S, w] and logw [B, S, H, D] (f32)."""
    b, s, _ = x.shape
    h, dd = num_heads(cfg), cfg.head_dim
    xr, xk, xv, xw, xg = _ddlerp(p, x, xx)
    r = layers.split_heads(xr @ p["wr"], h, dd)
    k = layers.split_heads(xk @ p["wk"], h, dd)
    v = layers.split_heads(xv @ p["wv"], h, dd)
    g = F.silu(xg @ p["wg"])
    logw = -torch.exp(p["decay_w0"] + torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"])
    return r, k, v, g, layers.split_heads(logw, h, dd).to(torch.float32)


def time_mix(p: dict, x: Tensor, cfg: ArchConfig, state: dict | None = None,
             chunk: int = 64) -> tuple[Tensor, dict]:
    """Full-sequence time-mix. ``state`` carries {shift [B, d], wkv [B, H, D, D]}."""
    b, s, d = x.shape
    h, dd = num_heads(cfg), cfg.head_dim
    if state is None:
        state = {"shift": torch.zeros((b, d), dtype=x.dtype, device=x.device),
                 "wkv": torch.zeros((b, h, dd, dd), dtype=torch.float32, device=x.device)}

    r, k, v, g, logw = _projections(p, x, _token_shift(x, state["shift"]), cfg)
    r, k, v = (t.to(torch.float32) for t in (r, k, v))

    def recurrence(r, k, v, logw, u, wkv):
        ys = []
        for c0 in range(0, s, chunk):
            part = slice(c0, c0 + chunk)
            y, wkv = _wkv_chunk(r[:, part], k[:, part], v[:, part], logw[:, part], u, wkv)
            ys.append(y)
        return torch.cat(ys, dim=1), wkv

    # dims of (batch, heads) in r, k, v, logw / bonus_u / the state
    y, wkv = _per_head(recurrence, r, [(r, 0, 2), (k, 0, 2), (v, 0, 2), (logw, 0, 2),
                                       (p["bonus_u"], None, 0), (state["wkv"], 0, 1)],
                       [(0, 2), (0, 1)])
    y = _head_group_norm(y, p["ln_x"], cfg.norm_eps)
    out = (y.to(x.dtype) * g) @ p["wo"]
    return out, {"shift": x[:, -1, :], "wkv": wkv}


def _head_group_norm(y: Tensor, weight: Tensor, eps: float) -> Tensor:
    """GroupNorm over each head's channels (RWKV's ln_x). y: [B, S, H, D]."""
    b, s, h, dd = y.shape
    mu = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, unbiased=False, keepdim=True)
    yn = (y - mu) * torch.rsqrt(var + eps)
    return yn.reshape(b, s, h * dd) * weight


def time_mix_decode(p: dict, x: Tensor, cfg: ArchConfig,
                    state: dict) -> tuple[Tensor, dict]:
    """One recurrent step. x: [B, 1, d]; returns (out [B, 1, d], new state)."""
    b = x.shape[0]
    h, dd = num_heads(cfg), cfg.head_dim
    r, k, v, g, logw = _projections(p, x, state["shift"][:, None, :].to(x.dtype), cfg)
    r, k, v = (t.reshape(b, h, dd).to(torch.float32) for t in (r, k, v))
    w = torch.exp(logw.reshape(b, h, dd))

    def step(r, k, v, w, u, s_prev):                        # s_prev [B, H, D, D]
        kv = torch.einsum("bhd,bhe->bhde", k, v)
        y = torch.einsum("bhd,bhde->bhe", r, s_prev) + torch.einsum(
            "bhd,hd,bhde->bhe", r, u, kv)
        return y, w[..., None] * s_prev + kv

    y, new_wkv = _per_head(step, r, [(r, 0, 1), (k, 0, 1), (v, 0, 1), (w, 0, 1),
                                     (p["bonus_u"], None, 0), (state["wkv"], 0, 1)],
                           [(0, 1), (0, 1)])

    y = _head_group_norm(y.reshape(b, 1, h, dd), p["ln_x"], cfg.norm_eps)
    out = (y.to(x.dtype) * g) @ p["wo"]
    return out, {"shift": x[:, -1, :], "wkv": new_wkv}


def channel_mix(p: dict, x: Tensor, state_shift: Tensor) -> tuple[Tensor, Tensor]:
    """RWKV channel-mix (squared-ReLU MLP with token shift). x: [B, S, d].
    Returns (out, the last token: the next call's shift)."""
    xx = _token_shift(x, state_shift)
    xk = x + (xx - x) * p["mix_k"]
    xr = x + (xx - x) * p["mix_r"]
    k = torch.square(torch.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"]), x[:, -1, :]
