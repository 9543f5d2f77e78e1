"""Solver for the paper's P1 (Eq. 11): per-vehicle aggregation weights.

  min_{alpha}  D_KL( sum_{k' in P_{k,t}} alpha_{k'} * s_{k'}  ||  g )
  s.t.         alpha on the probability simplex, alpha_{k'} = 0 outside P_{k,t}

P1 is convex over the simplex (KL is convex in its first argument, the mix is
linear in alpha). We solve it with *exponentiated gradient* (entropic mirror
descent): every iterate is strictly feasible, masked coordinates stay exactly
zero, and the iteration is a few elementwise ops + two small matrix products.

Counterpart of ``repro.core.kl_solver``. The reference vmaps one vehicle's
solve; here the vehicle axis is written out: ``alpha`` is ``[V, D]`` and the
neighbour states are either one shared ``[D, K]`` matrix (dense contacts,
``D = K``) or each vehicle's own ``[D, K]`` rows (neighbour lists). With a
leading seed axis (``run_seeds``) each seed solves against its own states
and target.

This module decides the route; ``kernels.kl_simplex`` supplies both. On the
card, f32 states whose ``[D, K]`` rows per vehicle fit one block's shared
memory (``kernel.eg_solve_fits``) take one launch of ``kernel.eg_solve_rows``:
neighbour lists through their ids, dense contacts with no ids, a seed axis
through the kernel's per-seed offsets, so nothing is gathered or repeated
first. Everything else (the CPU, ``meta`` tensors, the card past the fit)
takes the loop ``ref.eg_iterate``, whose step is the ``eg_step`` kernel on the
card and ``ref.eg_step_ref`` elsewhere. ``solve_counts`` counts the solves
each route took.

The objective and gradient are in **nats** (the state-vector diagnostics are
in bits; the argmin is the same).
"""
from __future__ import annotations

import torch

from ..kernels.kl_simplex import kernel as eg_kernel
from ..kernels.kl_simplex import ref as eg_ref
from . import contacts as contacts_lib

Tensor = torch.Tensor

_EPS = 1e-12

# solve_p1_all calls by route since the last reset_solve_counts(): "kernel"
# (one eg_solve_rows launch) or "eager" (the loop of ref.eg_iterate)
solve_counts: dict[str, int] = {"kernel": 0, "eager": 0}

# vehicles per block of the loop on neighbour lists: it holds the gathered
# neighbour states of a whole block — [block, D_max, K] floats — so blocking
# bounds that buffer at large K instead of holding the full [K, D_max, K]
# gather. Module-level so tests can shrink it to exercise the blocked path at
# tiny K.
P1_BLOCK = 256


def reset_solve_counts() -> None:
    for route in solve_counts:
        solve_counts[route] = 0


def kl_objective(alpha: Tensor, states: Tensor, target: Tensor) -> Tensor:
    """P1 objective in nats (argmin is identical to the bits version):
    ``alpha`` [D] or [V, D] over shared ``states`` [D, K], or [V, D] over
    each row's own [V, D, K]; zero-coordinate convention."""
    u = torch.matmul(alpha.unsqueeze(-2), states).squeeze(-2)
    uu = torch.clamp(u, _EPS, 1.0)
    gg = torch.clamp(target, _EPS, 1.0)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    return torch.sum(
        torch.where(u > _EPS, u * (torch.log(uu) - torch.log(gg)), zero), dim=-1)


def solve_p1(
    states: Tensor,
    target: Tensor,
    contact_mask: Tensor,
    num_steps: int = 400,
    step_size: float = 2.0,
) -> Tensor:
    """Solve P1 for ONE vehicle.

    Args:
      states: ``[D, K]`` — row k' is the (already exchanged) state vector
        s_{k',t+1/2} of candidate k' (``D = K`` for a dense contact row).
        Rows outside the contact set are ignored.
      target: ``[K]`` target vector g.
      contact_mask: ``[D]`` 0/1 — membership of P_{k,t} (must include self).
      num_steps: EG iterations.
      step_size: EG learning rate.

    Returns:
      ``[D]`` alpha, on the simplex, exactly zero off the contact set.
    """
    return eg_ref.eg_iterate(states, target, contact_mask[None], num_steps, step_size,
                             _step_for(states))[0]


def solve_p1_all(
    states: Tensor,
    target: Tensor,
    contacts,
    num_steps: int = 400,
    step_size: float = 2.0,
) -> Tensor:
    """Solve P1 for every vehicle simultaneously (batched EG).

    Args:
      states: ``[K, K]`` state matrix (row k' = s_{k',t+1/2}).
      target: ``[K]``.
      contacts: ``[K, K]`` 0/1 dense matrix, row k = P_{k,t} (diag must be
        1), or a ``contacts.SparseContacts`` neighbour list.

    Returns:
      Dense contacts: ``[K, K]`` alpha rows supported on the contact set.
      Sparse contacts: ``[K, D_max]`` per-slot alpha (zero on padding) on the
      neighbour-list layout — each vehicle's EG runs over its D_max slots
      against the gathered ``[D_max, K]`` neighbour states (the same solver
      body as the dense path, so the optima agree).

    With a seed axis every argument gains a leading ``[S]`` and so does the
    result. On the card one ``eg_solve_rows`` launch where a row's states fit
    one block (the same steps in full f32, within about 2e-7 of the loop),
    else the loop; see the module's docstring.
    """
    if _kernel_takes(states, contacts):
        solve_counts["kernel"] += 1
        return _solve_p1_kernel(states, target, contacts, num_steps, step_size)
    solve_counts["eager"] += 1
    return _solve_p1_loop(states, target, contacts, num_steps, step_size)


def _step_for(states: Tensor):
    """The loop's EG step: the ``eg_step`` kernel on the card, else its plain
    version."""
    return eg_kernel.eg_step if states.is_cuda else eg_ref.eg_step_ref


def _kernel_takes(states: Tensor, contacts) -> bool:
    """Whether ``solve_p1_all`` runs as one ``eg_solve_rows`` launch: f32
    states on the card whose ``[D, K]`` rows per vehicle (``D`` the neighbour
    slots, or the state matrix's rows for dense contacts) fit one block."""
    if not states.is_cuda or states.dtype != torch.float32:
        return False
    sparse = isinstance(contacts, contacts_lib.SparseContacts)
    d = contacts.idx.shape[-1] if sparse else states.shape[-2]
    return eg_kernel.eg_solve_fits(d, states.shape[-1], states.device)


def _solve_p1_kernel(states, target, contacts, num_steps, step_size) -> Tensor:
    """The whole solve in one launch: neighbour lists as the kernel's id table
    (seeds through its per-seed offsets), dense contacts with no table (each
    row over its seed's whole state matrix)."""
    ids, mask = None, contacts
    if isinstance(contacts, contacts_lib.SparseContacts):
        ids, mask = contacts.idx.to(torch.int32).contiguous(), contacts.mask
    return eg_kernel.eg_solve_rows(
        states.contiguous(), ids, target.to(torch.float32).contiguous(),
        mask.to(torch.float32).contiguous(), num_steps=num_steps, step_size=step_size)


def _solve_p1_loop(states, target, contacts, num_steps, step_size) -> Tensor:
    """``solve_p1_all`` as the loop of ``ref.eg_iterate``: dense contacts over
    the shared state matrix (each seed's own), neighbour lists over their
    gathered rows in blocks of ``P1_BLOCK`` vehicles, with a seed axis folded
    into the rows, each row against its own seed's target. (The last block
    is simply shorter: rows are independent, so no padding rows are
    needed.)"""
    step = _step_for(states)
    if not isinstance(contacts, contacts_lib.SparseContacts):
        return eg_ref.eg_iterate(states, target, contacts, num_steps, step_size, step)
    idx, mask = contacts.idx, contacts.mask
    if idx.dim() == 3:                   # seed axis: fold the seeds into rows
        s, k, d = idx.shape
        idx, mask = contacts_lib.seed_rows(idx), mask.reshape(s * k, d)
        states, target = states.reshape(s * k, -1), target.repeat_interleave(k, dim=0)
    idx = idx.long()
    per_row = target.dim() == 2
    out = [eg_ref.eg_iterate(states[idx[r:r + P1_BLOCK]],
                             target[r:r + P1_BLOCK] if per_row else target,
                             mask[r:r + P1_BLOCK], num_steps, step_size, step)
           for r in range(0, idx.shape[0], P1_BLOCK)]
    return torch.cat(out).reshape(contacts.mask.shape)
