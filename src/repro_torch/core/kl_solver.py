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
``D = K``) or a gathered ``[V, D, K]`` tensor (neighbour lists), and each EG
step is two batched contractions.

With a leading seed axis (``run_seeds``) the dense solve is the same EG over
``[S, K, K]`` (each contraction one product per seed, the one a single run
takes: ``contacts.seedwise_matmul``), and the
neighbour-list solve folds the seeds into its rows, each row against its own
seed's target.

On the card, ``solve_p1_all`` runs the whole solve as one launch of the
hand-written ``eg_solve`` kernel wherever a row's ``[D, K]`` states fit one
block's shared memory (``kernels.kl_simplex.kernel.eg_solve_fits``): on
neighbour lists through their ids, with a seed axis through the kernel's
per-seed offsets, so nothing is gathered or repeated first. Past that, and
on the CPU, it runs the eager loop below. The route is a choice by shape;
``solve_counts`` counts the solves each route took.

The objective and gradient are in **nats** (the state-vector diagnostics are
in bits; the argmin is the same).
"""
from __future__ import annotations

import torch

from ..kernels.kl_simplex import kernel as eg_kernel
from . import contacts as contacts_lib

Tensor = torch.Tensor

_EPS = 1e-12

# solve_p1_all calls by route since the last reset_solve_counts(): "kernel"
# (one eg_solve launch) or "eager" (the loop of _eg_solve)
solve_counts: dict[str, int] = {"kernel": 0, "eager": 0}


def reset_solve_counts() -> None:
    for route in solve_counts:
        solve_counts[route] = 0


def _kl_nats(u: Tensor, g: Tensor) -> Tensor:
    """KL(u || g) in nats; zero-coordinate convention."""
    uu = torch.clamp(u, _EPS, 1.0)
    gg = torch.clamp(g, _EPS, 1.0)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    return torch.sum(
        torch.where(u > _EPS, u * (torch.log(uu) - torch.log(gg)), zero), dim=-1)


def _per_row(alpha: Tensor, states: Tensor) -> bool:
    """True when every row of ``alpha`` [V, D] has its own ``[D, K]`` states
    (``states`` [V, D, K])."""
    return alpha.dim() == 2 and states.dim() == 3


def mixed_state(alpha: Tensor, states: Tensor) -> Tensor:
    """u = alpha^T S : the post-aggregation state vector. ``alpha`` [D] with
    ``states`` [D, K], or batched ``alpha`` [V, D] with ``states`` [D, K]
    (shared) / [V, D, K] (per row), or ``alpha`` [S, V, D] with ``states``
    [S, D, K] (shared within each seed)."""
    if _per_row(alpha, states):
        return torch.bmm(alpha.unsqueeze(1), states).squeeze(1)
    if alpha.dim() == 3:
        return contacts_lib.seedwise_matmul(alpha, states)
    return alpha @ states


def kl_objective(alpha: Tensor, states: Tensor, target: Tensor) -> Tensor:
    """P1 objective in nats (argmin is identical to the bits version)."""
    return _kl_nats(mixed_state(alpha, states), target)


def _kl_grad(alpha: Tensor, states: Tensor, log_g: Tensor) -> Tensor:
    """Analytic gradient: d/d alpha_i = sum_j S[i,j] (log(u_j/g_j) + 1)."""
    u = torch.clamp(mixed_state(alpha, states), min=_EPS)
    r = torch.log(u) - log_g + 1.0
    if _per_row(alpha, states):
        return torch.bmm(states, r.unsqueeze(-1)).squeeze(-1)
    if alpha.dim() == 3:
        return contacts_lib.seedwise_matmul(r, states.transpose(-2, -1))
    return r @ states.T


def _eg_solve(states: Tensor, target: Tensor, mask: Tensor, num_steps: int,
              step_size: float) -> Tensor:
    """Batched EG: ``mask`` [V, D] 0/1, ``states`` [D, K] or [V, D, K];
    returns ``alpha`` [V, D] on the simplex, exactly zero off the mask.
    ``target`` is [K], or one target per row ([V, K]; [S, 1, K] with a seed
    axis on ``mask`` [S, V, D] and ``states`` [S, D, K])."""
    mask = mask.to(states.dtype)
    active = mask > 0
    n_active = torch.clamp(torch.sum(mask, dim=-1, keepdim=True), min=1.0)
    alpha = mask / n_active
    log_g = torch.log(torch.clamp(target, min=_EPS))
    neg_inf = torch.full((), float("-inf"), dtype=states.dtype,
                         device=states.device)
    for _ in range(num_steps):
        grad = _kl_grad(alpha, states, log_g)
        # Center the gradient over active coords: EG is invariant to constant
        # shifts, centering improves conditioning of the exponent. Normalize
        # the step by the active gradient range so one EG step never moves
        # log-weights by more than ``step_size``.
        gbar = torch.sum(grad * mask, dim=-1, keepdim=True) / n_active
        centered = (grad - gbar) * mask
        scale = step_size / torch.clamp(
            torch.amax(torch.abs(centered), dim=-1, keepdim=True), min=1.0)
        logits = torch.where(
            active, torch.log(torch.clamp(alpha, _EPS, 1.0)) - scale * centered,
            neg_inf)
        new = torch.softmax(logits, dim=-1) * mask
        alpha = new / torch.clamp(torch.sum(new, dim=-1, keepdim=True), min=_EPS)
    return alpha


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
    return _eg_solve(states, target, contact_mask[None], num_steps, step_size)[0]


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

    On the card one ``eg_solve`` launch where a row's states fit one block
    (the same steps in full f32, within about 2e-7 of the eager loop), else
    the eager loop; see the module's docstring.
    """
    if _kernel_takes(states, contacts):
        solve_counts["kernel"] += 1
        return _solve_p1_kernel(states, target, contacts, num_steps, step_size)
    solve_counts["eager"] += 1
    return _solve_p1_eager(states, target, contacts, num_steps, step_size)


def _kernel_takes(states: Tensor, contacts) -> bool:
    """Whether ``solve_p1_all`` runs as one ``eg_solve`` launch: f32 states on
    the card whose ``[D, K]`` rows per vehicle (``D`` the neighbour slots, or
    the state matrix's rows for dense contacts) fit one block."""
    if not states.is_cuda or states.dtype != torch.float32:
        return False
    sparse = isinstance(contacts, contacts_lib.SparseContacts)
    d = contacts.idx.shape[-1] if sparse else states.shape[-2]
    return eg_kernel.eg_solve_fits(d, states.shape[-1], states.device)


def _solve_p1_kernel(states, target, contacts, num_steps, step_size) -> Tensor:
    """The whole solve in one launch: neighbour lists as the kernel's id table
    (seeds through its per-seed offsets), dense contacts as the shared state
    matrix (with a seed axis, the identity table per seed)."""
    kw = dict(num_steps=num_steps, step_size=step_size)
    target = target.to(torch.float32).contiguous()
    if isinstance(contacts, contacts_lib.SparseContacts):
        return eg_kernel.eg_solve_rows(
            states.contiguous(), contacts.idx.to(torch.int32).contiguous(), target,
            contacts.mask.to(torch.float32).contiguous(), **kw)
    mask = contacts.to(torch.float32).contiguous()
    if states.dim() == 3:
        return eg_kernel.eg_solve_rows(states.contiguous(), None, target, mask, **kw)
    return eg_kernel.eg_solve(states.contiguous(), target, mask, **kw)


def _solve_p1_eager(states, target, contacts, num_steps, step_size) -> Tensor:
    """``solve_p1_all`` as the loop of ``_eg_solve``: on the CPU, and on the
    card where a row's states do not fit one block of ``eg_solve``."""
    if isinstance(contacts, contacts_lib.SparseContacts):
        if contacts.idx.dim() == 3:      # seed axis: fold the seeds into rows
            s, k, d = contacts.idx.shape
            folded = contacts_lib.SparseContacts(
                contacts_lib.seed_rows(contacts.idx), contacts.mask.reshape(s * k, d))
            alpha = _solve_p1_neighbours(
                states.reshape(s * k, -1), target.repeat_interleave(k, dim=0),
                folded, num_steps, step_size)
            return alpha.reshape(s, k, d)
        return _solve_p1_neighbours(states, target, contacts, num_steps,
                                    step_size)
    if target.dim() == 2:                # seed axis: [S, K] -> [S, 1, K]
        target = target.unsqueeze(-2)
    return _eg_solve(states, target, contacts, num_steps, step_size)


# vehicles per block of the sparse P1 solve: the batched EG holds the gathered
# neighbour states for a whole block — [block, D_max, K] floats — so blocking
# bounds that buffer at large K instead of holding the full [K, D_max, K]
# gather. Module-level so tests can shrink it to exercise the blocked path at
# tiny K.
P1_BLOCK = 256


def _solve_p1_neighbours(states, target, contacts, num_steps, step_size) -> Tensor:
    """Per-vehicle EG over the neighbour slots, in row blocks of ``P1_BLOCK``
    vehicles. (The last block is simply shorter: rows are independent, so no
    padding rows are needed.) ``target`` is [K], or [rows, K] — one per row."""
    idx, mask = contacts.idx.long(), contacts.mask
    k = idx.shape[0]
    block = min(P1_BLOCK, k)
    per_row = target.dim() == 2
    out = [_eg_solve(states[idx[s:s + block]],
                     target[s:s + block] if per_row else target,
                     mask[s:s + block], num_steps, step_size)
           for s in range(0, k, block)]
    return out[0] if len(out) == 1 else torch.cat(out, dim=0)
