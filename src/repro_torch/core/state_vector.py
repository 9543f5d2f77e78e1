"""State vectors: per-vehicle record of each data source's contribution weight.

Implements Eqs. (5)-(7) of the paper:

  Eq. (5): s^k_{k,t+1/2} = s^k_{k,t} + eta_t           (once per local iteration)
  Eq. (6): normalize the state vector to the simplex
  Eq. (7): s_{k,t+1} = sum_{k' in P_{k,t}} alpha^k_{k',t} s_{k',t+1/2}

All functions are batched over the vehicle axis (leading dim K) so the whole
federation's state lives in one ``[K, K]`` matrix ``S`` with ``S[k, k']`` the
contribution weight of source ``k'`` to vehicle ``k``'s model. They also take
a leading seed axis: ``[S, K, K]`` states with ``[S, K]`` targets and masks.
"""
from __future__ import annotations

import torch

from . import contacts as contacts_lib

Tensor = torch.Tensor


def init_state(num_vehicles: int, dtype=torch.float32, device=None) -> Tensor:
    """All-zero state matrix ``[K, K]`` (paper: 'Initially, all values in a
    state vector are assigned with 0')."""
    return torch.zeros((num_vehicles, num_vehicles), dtype=dtype, device=device)


def local_update(state: Tensor, lr: float, local_steps: int,
                 update_mask: Tensor | None = None) -> Tensor:
    """Eq. (5) applied ``local_steps`` times followed by Eq. (6).

    Each vehicle k adds ``lr`` to its own coordinate once per local iteration,
    then renormalizes. Batched: adds ``local_steps * lr`` to the diagonal.

    ``update_mask`` [K] restricts the bump to participants that actually run
    local iterations — RSUs (paper Sec. V-C) hold no data and must not
    increase their own contribution weight.
    """
    k = state.shape[-1]
    # the product is taken in the state's dtype, as two f32 scalars
    bump = (torch.tensor(lr, dtype=state.dtype, device=state.device)
            * torch.tensor(local_steps, dtype=state.dtype, device=state.device))
    diag = torch.eye(k, dtype=state.dtype, device=state.device)
    if update_mask is not None:
        diag = diag * update_mask.to(state.dtype).unsqueeze(-1)
    state = state + bump * diag
    return normalize(state)


def normalize(state: Tensor, eps: float = 1e-12) -> Tensor:
    """Eq. (6): row-normalize onto the simplex (rows that are all-zero stay zero)."""
    tot = torch.sum(state, dim=-1, keepdim=True)
    return torch.where(tot > eps, state / torch.clamp(tot, min=eps), state)


def aggregate(state: Tensor, mixing) -> Tensor:
    """Eq. (7) for all vehicles at once: ``S' = W @ S``.

    ``mixing[k, k']`` is alpha^k_{k'} (zero outside the contact set), each row
    summing to one, so every row of the result is the convex combination of the
    neighbours' state vectors. A ``contacts.SparseMixing`` applies the same
    combination as a neighbour gather + slot sum.
    """
    if isinstance(mixing, contacts_lib.SparseMixing):
        return contacts_lib.sparse_mix_array(mixing, state)
    if mixing.dim() == 3:                   # a seed axis: a single run's product
        return contacts_lib.seedwise_matmul(mixing, state)
    return mixing @ state


def entropy(state: Tensor, eps: float = 1e-12) -> Tensor:
    """Eq. (8): per-vehicle entropy H(s_k) in bits. ``state`` rows must be on
    the simplex. Returns ``[K]``."""
    p = torch.clamp(state, eps, 1.0)
    zero = torch.zeros((), dtype=state.dtype, device=state.device)
    return -torch.sum(torch.where(state > eps, state * torch.log2(p), zero), dim=-1)


def kl_to_target(state: Tensor, target: Tensor, eps: float = 1e-12) -> Tensor:
    """Eq. (9): per-vehicle D_KL(s_k || g) in bits. Returns ``[K]``.

    Coordinates where s=0 contribute 0 (standard KL convention).
    """
    s = torch.clamp(state, eps, 1.0)
    g = torch.clamp(target, eps, 1.0)
    zero = torch.zeros((), dtype=state.dtype, device=state.device)
    terms = torch.where(state > eps,
                        state * (torch.log2(s) - torch.log2(g).unsqueeze(-2)), zero)
    return torch.sum(terms, dim=-1)


def target_state(sample_counts) -> Tensor:
    """The target vector g = (n_1/n, ..., n_K/n)."""
    n = torch.as_tensor(sample_counts).to(torch.float32)
    return n / torch.sum(n)

