"""Operation and traffic counts of a torch function, by running it once.

Counterpart of ``repro.roofline.hlo_cost``, which parses the optimized HLO
text of a compiled JAX program. Eager torch has no HLO, so nothing is
parsed here: ``analyze_fn`` runs the function once under two dispatch modes
and counts what the dispatcher sees.

* **Flops** come from ``torch.utils.flop_counter.FlopCounterMode``: matrix
  products, convolutions and attention, forward and backward (the autograd
  engine dispatches the backward through the same modes). Data movement such
  as ``F.unfold`` counts no flops: the port's CNN extracts its patches with
  ``F.unfold`` where the reference's ``conv_general_dilated_patches`` lowers
  to convolutions that the HLO parser counts as arithmetic, so the reference
  reports more flops for the same training step (PERF.md, cost model).
* **Traffic** is the reference's definition (``hlo_cost.py``: operand plus
  result bytes of every top-level op) applied to eager torch: the bytes of
  every tensor each aten op reads or writes, views excluded. Eager torch
  fuses nothing, so this is the unfused traffic — an upper bound on what a
  fused program moves.

The function runs on whatever device its arguments live on: the CPU or the
``meta`` device (shapes only, nothing computed). It is a counter, not a
runner: nothing of a federation runs through it.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode


def _tensor_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class TrafficMode(TorchDispatchMode):
    """Sums the operand and result bytes of every aten op dispatched while
    active (views, which move nothing, excluded)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


def analyze_fn(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count its work:
    ``{"flops_per_device", "traffic_bytes_per_device"}`` (the reference's
    keys; the whole call runs on one device, so per device is the total)."""
    flops = FlopCounterMode(display=False)
    traffic = TrafficMode()
    with flops, traffic:
        fn(*args, **kwargs)
    return {"flops_per_device": float(flops.get_total_flops()),
            "traffic_bytes_per_device": float(traffic.bytes)}
