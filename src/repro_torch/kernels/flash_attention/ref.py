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
