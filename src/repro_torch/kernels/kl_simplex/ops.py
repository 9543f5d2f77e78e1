"""Public wrappers of the kl_simplex diagnostics over a whole state matrix.

Counterpart of ``repro.kernels.kl_simplex.ops``. A CUDA tensor launches the
kernel (or raises); a CPU tensor takes the plain version in ``ref`` — for
that reason only, as the reference takes its oracle off the TPU. The P1
solve has one entry, ``core.kl_solver.solve_p1_all``, which routes between
``kernel.eg_solve_rows`` and the loop ``ref.eg_iterate``.
"""
from __future__ import annotations

import torch

from . import kernel, ref

Tensor = torch.Tensor


def kl_rows(states: Tensor, target: Tensor) -> Tensor:
    """Per-row ``D_KL(states[v] || target)`` in bits, ``[V, K]`` -> ``[V]``."""
    if states.is_cuda:
        return kernel.kl_rows(states, target.to(torch.float32).contiguous())
    return ref.kl_rows_ref(states, target)


def entropy_rows(states: Tensor) -> Tensor:
    """Per-row entropy in bits, ``[V, K]`` -> ``[V]``."""
    if states.is_cuda:
        return kernel.entropy_rows(states)
    return ref.entropy_rows_ref(states)
