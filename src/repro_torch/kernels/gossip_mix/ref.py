"""Plain PyTorch versions of the gossip_mix kernels (same functions, same
f32 accumulation); the CPU path of ``ops`` and the yardstick the CUDA
kernels are held against on the card."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def gossip_mix_matmul_ref(mixing: Tensor, flat: Tensor) -> Tensor:
    """``out = mixing @ flat`` in full f32, cast back to ``flat.dtype``;
    with a seed axis, ``mixing`` [S, K_out, K_in] and ``flat`` [S, K_in, P]
    give ``out[s] = mixing[s] @ flat[s]``."""
    out = mixing.to(torch.float32) @ flat.to(torch.float32)
    return out.to(flat.dtype)


def gossip_mix_gather_ref(idx: Tensor, w: Tensor, flat: Tensor) -> Tensor:
    """``out[k] = sum_d w[k, d] * flat[idx[k, d]]``. Materializes the
    [K, D, P] gather — fine as a correctness reference (the memory-safe plain
    path is ``core.contacts.sparse_mix_array``'s slot loop). With a seed axis,
    idx / w ``[S, K_out, D]`` (ids into each seed's own rows) over ``flat``
    ``[S, K_in, P]`` give ``out[s, k] = sum_d w[s, k, d] * flat[s, idx[s, k,
    d]]``."""
    if idx.dim() == 3:
        s, k_out, d = idx.shape
        k_in = flat.shape[1]
        rows = idx.long() + (torch.arange(s, device=idx.device) * k_in).reshape(s, 1, 1)
        out = gossip_mix_gather_ref(rows.reshape(s * k_out, d),
                                    w.reshape(s * k_out, d), flat.reshape(s * k_in, -1))
        return out.reshape(s, k_out, -1)
    gathered = flat[idx.long()].to(torch.float32)           # [K, D, P]
    out = torch.einsum("kd,kdp->kp", w.to(torch.float32), gathered)
    return out.to(flat.dtype)
