"""Plain PyTorch versions of the gossip_mix kernels (same functions, same
f32 accumulation); the CPU path of ``ops`` and the yardstick the CUDA
kernels are held against on the card."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def gossip_mix_matmul_ref(mixing: Tensor, flat: Tensor) -> Tensor:
    """``out = mixing @ flat`` in full f32, cast back to ``flat.dtype``."""
    out = mixing.to(torch.float32) @ flat.to(torch.float32)
    return out.to(flat.dtype)


def gossip_mix_gather_ref(idx: Tensor, w: Tensor, flat: Tensor) -> Tensor:
    """``out[k] = sum_d w[k, d] * flat[idx[k, d]]``. Materializes the
    [K, D, P] gather — fine as a correctness reference (the memory-safe plain
    path is ``core.contacts.sparse_mix_array``'s slot loop)."""
    gathered = flat[idx.long()].to(torch.float32)           # [K, D, P]
    out = torch.einsum("kd,kdp->kp", w.to(torch.float32), gathered)
    return out.to(flat.dtype)
