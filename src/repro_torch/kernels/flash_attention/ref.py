"""Plain PyTorch attention with GQA, causal and sliding-window masking: the
counterpart of ``repro.kernels.flash_attention.ref.flash_attention_ref``
(same signature, f32 math, ``-inf`` masking, output in ``q.dtype``).

A query row with no key left after masking gives NaN here (a softmax over
``-inf`` only), as in the reference's plain version; the kernel gives 0.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                        window: int | None = None,
                        scale: float | None = None) -> Tensor:
    """q: [B, S, H, hd]; k/v: [B, T, KV, hd] with H % KV == 0. Returns
    [B, S, H, hd] in q.dtype."""
    b, s, h, hd = q.shape
    _, t, kv, _ = k.shape
    group = h // kv
    scale = hd ** -0.5 if scale is None else scale

    qg = q.reshape(b, s, kv, group, hd).to(torch.float32)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32)) * scale
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    logits = torch.where(mask, logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(torch.float32))
    return out.reshape(b, s, h, hd).to(q.dtype)


def _train_probs(q: Tensor, k: Tensor, window: int | None, scale: float):
    """The kept mask [S, S] and the scaled f32 scores [B, KV, G, S, S]."""
    b, s, h, dqk = q.shape
    kv = k.shape[2]
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    qg = q.reshape(b, s, kv, h // kv, dqk).to(torch.float32)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32)) * scale
    return mask, scores


def flash_train_forward_ref(q: Tensor, k: Tensor, v: Tensor, *, window: int | None = None,
                            scale: float | None = None) -> tuple[Tensor, Tensor]:
    """Plain twin of the training kernels' forward (``csrc/flash_train.cu``),
    in f32: q [B, S, H, dqk], k [B, S, KV, dqk], v [B, S, KV, dv], causal (+
    window). Returns (o [B, S, H, dv] in q.dtype, lse [B, H, S] f32: the
    natural log-sum-exp of each row's kept scaled scores)."""
    b, s, h, dqk = q.shape
    scale = dqk ** -0.5 if scale is None else scale
    mask, scores = _train_probs(q, k, window, scale)
    lse = torch.logsumexp(torch.where(mask, scores, float("-inf")), dim=-1)   # [b, kv, g, s]
    p = torch.where(mask, torch.exp(scores - lse[..., None]), 0.0)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return o.reshape(b, s, h, v.shape[-1]).to(q.dtype), lse.reshape(b, h, s)


def flash_train_backward_ref(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
                             dout: Tensor, *, window: int | None = None,
                             scale: float | None = None) -> tuple[Tensor, Tensor, Tensor]:
    """Plain twin of the training kernels' backward, in f32, by their
    equations: D = rowsum(dO o); P recomputed from q, k and the saved lse;
    dV = P^T dO, dP = dO V^T, dS = P (dP - D), dQ = scale dS K, dK = scale
    dS^T Q (summed over a GQA group's q-heads). Returns (dq, dk, dv) in the
    dtypes of q, k, v."""
    b, s, h, dqk = q.shape
    kv = k.shape[2]
    g = h // kv
    f32 = torch.float32
    scale = dqk ** -0.5 if scale is None else scale
    mask, scores = _train_probs(q, k, window, scale)
    p = torch.where(mask, torch.exp(scores - lse.reshape(b, kv, g, s)[..., None]), 0.0)
    do = dout.reshape(b, s, kv, g, -1).to(f32)
    d = (do * o.reshape(b, s, kv, g, -1).to(f32)).sum(-1).permute(0, 2, 3, 1)   # [b, kv, g, s]
    dv = torch.einsum("bkgst,bskgd->btkd", p, do)
    dp = torch.einsum("bskgd,btkd->bkgst", do, v.to(f32))
    ds = p * (dp - d[..., None])
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.to(f32)) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, q.reshape(b, s, kv, g, dqk).to(f32)) * scale
    return dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
