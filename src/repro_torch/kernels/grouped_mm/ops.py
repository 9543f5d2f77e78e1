"""The grouped products as custom ops, and the entry point the MoE calls.

The port of ``jax.lax.ragged_dot`` (no Pallas kernel: the reference leaves it
to XLA). On the card its bodies are the hand-written Hopper kernels of
``kernel``: bound by operations at prefill shapes, they run bf16 on
``wgmma`` and f32 as 3xTF32 on ``mma.sync``, each product one persistent
launch on a tile schedule built on the device from the offsets, fed by TMA
(design note in ``csrc/grouped_mm.cu``).

``repro_torch::grouped_mm(x, w, offsets, trans_w=False)`` and
``repro_torch::grouped_mm_wgrad(x, dy, offsets)`` are registered with
``torch.library.custom_op``:

* on CUDA they launch the kernels of ``kernel`` (inputs made contiguous
  first); on the CPU they run the plain versions of ``ref``;
* ``register_fake`` gives their output shapes on any device, ``meta``
  included, so the dry run (``launch.dryrun``) steps through them;
* ``register_autograd`` wires ``grouped_mm``'s gradient:
  ``dx = grouped_mm(dy, w, offsets, not trans_w)`` (the same kernel, the
  transpose flag flipped) and ``dw = grouped_mm_wgrad(x, dy, offsets)``
  (``(dy, x)`` for a transposed w);
* ``torch.utils.flop_counter`` counts 2·M·K·N per product (``FlopCounterMode``
  and ``launch.dryrun.DeviceCounter``).

``grouped_mm``, the entry point the MoE calls, is the custom op on every
device, so the CPU runs the same registered backward as the card; only the
op's body differs (the plain version on the CPU, the kernel on CUDA: there
is no silent fallback on the card).
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from . import kernel
from .ref import grouped_mm_ref, grouped_mm_wgrad_ref

Tensor = torch.Tensor


@torch.library.custom_op("repro_torch::grouped_mm", mutates_args=())
def grouped_mm_op(x: Tensor, w: Tensor, offsets: Tensor, trans_w: bool = False) -> Tensor:
    if x.is_cuda:
        return kernel.grouped_mm(x.contiguous(), w.contiguous(), offsets.contiguous(),
                                 trans_w)
    return grouped_mm_ref(x, w, offsets, trans_w)


@torch.library.custom_op("repro_torch::grouped_mm_wgrad", mutates_args=())
def grouped_mm_wgrad_op(x: Tensor, dy: Tensor, offsets: Tensor) -> Tensor:
    if x.is_cuda:
        return kernel.grouped_mm_wgrad(x.contiguous(), dy.contiguous(),
                                       offsets.contiguous())
    return grouped_mm_wgrad_ref(x, dy, offsets)


@grouped_mm_op.register_fake
def _grouped_mm_fake(x, w, offsets, trans_w=False):
    return x.new_empty((x.shape[0], w.shape[1] if trans_w else w.shape[2]))


@grouped_mm_wgrad_op.register_fake
def _grouped_mm_wgrad_fake(x, dy, offsets):
    return x.new_empty((offsets.shape[0] - 1, x.shape[1], dy.shape[1]))


def _save_inputs(ctx, inputs, output):
    x, w, offsets, trans_w = inputs
    ctx.save_for_backward(x, w, offsets)
    ctx.trans_w = trans_w


def _grouped_mm_backward(ctx, dy):
    x, w, offsets = ctx.saved_tensors
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = grouped_mm_op(dy, w, offsets, not ctx.trans_w)
    if ctx.needs_input_grad[1]:
        dw = (grouped_mm_wgrad_op(dy, x, offsets) if ctx.trans_w
              else grouped_mm_wgrad_op(x, dy, offsets))
    return dx, dw, None, None


grouped_mm_op.register_autograd(_grouped_mm_backward, setup_context=_save_inputs)


@register_flop_formula(torch.ops.repro_torch.grouped_mm)
def _grouped_mm_flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * x_shape[0] * x_shape[1] * out_shape[1]


@register_flop_formula(torch.ops.repro_torch.grouped_mm_wgrad)
def _grouped_mm_wgrad_flops(x_shape, dy_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * x_shape[0] * x_shape[1] * dy_shape[1]


# x [M, K]; w [E, K, N] (``trans_w``: [E, N, K]); offsets [E + 1] int32 on
# x's device -> [M, N]: rows ``offsets[e]:offsets[e+1]`` of x times ``w[e]``,
# 0 for rows in no group. Differentiable in x and w.
grouped_mm = grouped_mm_op
