"""Public wrappers of the kl_simplex kernels: the state diagnostics over a
whole state matrix and the kernel-backed P1 solver.

Counterpart of ``repro.kernels.kl_simplex.ops``. A CUDA tensor launches the
kernel (or raises); a CPU tensor takes the plain version in ``ref`` — for
that reason only, as the reference takes its oracle off the TPU.

``solve_p1_all_fused`` runs the P1 iteration on the card in one launch of
the ``eg_solve`` kernel where the state matrix fits one block's shared
memory (``kernel.eg_solve_fits``: up to K = 234 on an H100), and otherwise as
a loop of full-f32 ``torch.matmul`` products with one ``eg_step`` launch per
step — a choice by shape alone, between two paths on the card. Like the
reference it is an entry point of its own: the engine's ``dds_round`` calls
``core.kl_solver.solve_p1_all``.
"""
from __future__ import annotations

import torch

from ...core.contacts import SparseContacts
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


def solve_p1_all_fused(states: Tensor, target: Tensor, contact_matrix: Tensor, *,
                       num_steps: int = 400, step_size: float = 2.0) -> Tensor:
    """Kernel-backed drop-in for ``core.kl_solver.solve_p1_all`` on a dense
    ``[K, K]`` 0/1 contact matrix: returns alpha ``[K, K]``, rows on the
    simplex, exactly 0 off the contacts (a vehicle with no contact gets a row
    of 0). On the card one ``eg_solve`` launch where the states fit one
    block, else one ``eg_step`` launch per step. Dense only, as in the
    reference."""
    if isinstance(contact_matrix, SparseContacts):
        raise TypeError("solve_p1_all_fused takes a dense [K, K] contact matrix; "
                        "neighbour lists go through core.kl_solver.solve_p1_all")
    s = states.to(torch.float32).contiguous()
    g = target.to(torch.float32).contiguous()
    m = contact_matrix.to(torch.float32).contiguous()
    if not s.is_cuda:
        return ref.eg_solve_ref(s, g, m, num_steps=num_steps, step_size=step_size)
    if kernel.eg_solve_fits(*s.shape, s.device):
        return kernel.eg_solve(s, g, m, num_steps=num_steps, step_size=step_size)
    return _solve_per_step(s, g, m, num_steps, step_size)


def _solve_per_step(states: Tensor, target: Tensor, mask: Tensor, num_steps: int,
                    step_size: float) -> Tensor:
    """The P1 iteration on the card for a state matrix past ``eg_solve``'s
    limit: full-f32 ``torch.matmul`` products and one ``eg_step`` launch per
    step."""
    return ref.eg_iterate(states, target, mask, num_steps, step_size, kernel.eg_step)
