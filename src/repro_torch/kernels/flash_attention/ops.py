"""The attention entry point and the attention-module adapter.

Counterpart of ``repro.kernels.flash_attention.ops``. ``attend`` sends CUDA
tensors to the kernel (or raises) and CPU tensors to the plain version in
``ref`` — for that reason only, as the reference takes its oracle off the
TPU. There is no other switch.

``make_attn_impl`` returns a drop-in for ``repro_torch.models.attention``'s
``_sdpa`` signature ``(q, k, v, mask, scale)``: the mask argument is ignored
in favour of the kernel's structural causal (+ window) flags, which is what
the model builds for train / prefill (the model hands an ``attn_impl``
``None`` as the mask and builds none).
"""
from __future__ import annotations

from . import kernel
from .ref import flash_attention_ref


def attend(q, k, v, *, causal: bool = True, window: int | None = None,
           scale: float | None = None):
    """q: [B, S, H, hd]; k/v: [B, T, KV, hd] -> [B, S, H, hd] in q.dtype."""
    if q.is_cuda:
        return kernel.flash_attention(q, k, v, causal=causal, window=window, scale=scale)
    return flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)


def make_attn_impl(window: int | None = None):
    """Adapter with the ``(q, k, v, mask, scale)`` signature used by
    ``repro_torch.models.attention``. Pass as ``attn_impl=`` to
    ``forward()`` / ``prefill()``."""

    def impl(q, k, v, mask, scale):
        del mask  # structural: causal (+ window) is what the model builds; None there
        return attend(q, k, v, causal=True, window=window, scale=scale)

    return impl
