"""Public wrappers of the kl_simplex kernels: the state diagnostics over a
whole state matrix and the kernel-backed P1 solver.

Counterpart of ``repro.kernels.kl_simplex.ops``. A CUDA tensor launches the
kernel (or raises); a CPU tensor takes the plain version in ``ref`` — for
that reason only, as the reference takes its oracle off the TPU.

``solve_p1_all_fused`` runs the P1 iteration with the fused ``eg_step``
kernel; the gradient (two ``[V, K] x [K, K]`` products) stays
``torch.matmul`` at full f32, as the reference leaves it to XLA. Like the
reference it is an entry point of its own: the engine's ``dds_round`` calls
``core.kl_solver.solve_p1_all``.
"""
from __future__ import annotations

import torch

from ...core.contacts import SparseContacts
from ...precision import full_f32_matmul
from . import kernel, ref

Tensor = torch.Tensor

_EPS = 1e-12


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


def solve_p1_all_fused(states: Tensor, target: Tensor, contact_matrix: Tensor, *,
                       num_steps: int = 400, step_size: float = 2.0) -> Tensor:
    """Kernel-backed drop-in for ``core.kl_solver.solve_p1_all`` on a dense
    ``[K, K]`` 0/1 contact matrix: returns alpha ``[K, K]``, rows on the
    simplex, exactly 0 off the contacts. One ``eg_step`` launch per step on
    the card. Dense only, as in the reference."""
    if isinstance(contact_matrix, SparseContacts):
        raise TypeError("solve_p1_all_fused takes a dense [K, K] contact matrix; "
                        "neighbour lists go through core.kl_solver.solve_p1_all")
    s = states.to(torch.float32)
    m = contact_matrix.to(torch.float32).contiguous()
    alpha = m / torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1.0)
    log_g = torch.log(torch.clamp(target.to(torch.float32), min=_EPS))
    step = kernel.eg_step if s.is_cuda else ref.eg_step_ref
    with full_f32_matmul():
        for _ in range(num_steps):
            u = torch.clamp(alpha @ s, min=_EPS)          # [V, K] mixed states
            grad = (torch.log(u) - log_g + 1.0) @ s.T     # [V, K] dKL/dalpha
            alpha = step(alpha, grad, m, step_size=step_size)
    return alpha
