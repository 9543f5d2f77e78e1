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

``make_train_attn_impl`` is the train step's attention
(``launch.steps.build_dds_train_step`` takes it when its ``attn_impl`` is
None), routed by what its inputs show (``kernel.train_takes``): CUDA bf16
q / k / v at a width pair of ``kernel.TRAIN_WIDTHS`` go to the training
kernels (``kernel.flash_train_attention``, forward and backward on the card);
everything else (CPU and meta tensors, DTensors, f32, other widths) to the
plain ``models.attention._sdpa`` with the causal mask, as the model builds it
without an ``attn_impl``.
"""
from __future__ import annotations

from ...models import attention, layers
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


def make_train_attn_impl(window: int | None = None):
    """The train step's adapter with the ``(q, k, v, mask, scale)`` signature:
    causal (+ ``window``, the config's ``sliding_window``) attention through
    the training kernels where ``kernel.train_takes(q, k, v)``, else through
    ``_sdpa`` with ``layers.causal_mask`` (the same call, bit for bit, as the
    model makes without an ``attn_impl``)."""

    def impl(q, k, v, mask, scale):
        del mask  # structural, as make_attn_impl's
        if kernel.train_takes(q, k, v):
            return kernel.flash_train_attention(q, k, v, window=window, scale=scale)
        s = q.shape[1]
        return attention._sdpa(q, k, v, layers.causal_mask(s, s, 0, window, device=q.device),
                               scale)

    return impl
