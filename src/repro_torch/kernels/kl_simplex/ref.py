"""Plain PyTorch versions of the kl_simplex kernels (the reference's
``repro.kernels.kl_simplex.ref`` on tensors): the CPU path of ``ops``, the
yardstick the CUDA kernels are held against on the card, and the P1 loop
``eg_iterate`` that ``core.kl_solver.solve_p1_all`` runs wherever the
one-launch solve does not take the shape."""
from __future__ import annotations

import torch

from ...precision import full_f32_matmul

Tensor = torch.Tensor

_EPS = 1e-12


def kl_rows_ref(states: Tensor, target: Tensor) -> Tensor:
    """Per-row ``D_KL(states[v] || target)`` in bits -> ``[V]`` f32."""
    raw = states.to(torch.float32)
    s = torch.clamp(raw, _EPS, 1.0)
    g = torch.clamp(target.to(torch.float32), _EPS, 1.0)
    terms = torch.where(raw > _EPS, raw * (torch.log2(s) - torch.log2(g)[None, :]),
                        torch.zeros((), device=raw.device))
    return torch.sum(terms, dim=-1)


def entropy_rows_ref(states: Tensor) -> Tensor:
    """Per-row entropy in bits -> ``[V]`` f32."""
    raw = states.to(torch.float32)
    s = torch.clamp(raw, _EPS, 1.0)
    terms = torch.where(raw > _EPS, raw * torch.log2(s),
                        torch.zeros((), device=raw.device))
    return -torch.sum(terms, dim=-1)


def eg_step_ref(alpha: Tensor, grad: Tensor, mask: Tensor,
                step_size: float = 2.0) -> Tensor:
    """One masked exponentiated-gradient step per row -> ``[V, K]`` f32.

    As the reference's ``eg_step_ref``: a softmax over the masked logits, so
    a row with an empty mask (all logits -inf) gives NaN, where the kernel
    gives 0."""
    a = alpha.to(torch.float32)
    g = grad.to(torch.float32)
    m = mask.to(torch.float32)
    n_act = torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1.0)
    gbar = torch.sum(g * m, dim=1, keepdim=True) / n_act
    centered = (g - gbar) * m
    scale = step_size / torch.clamp(
        torch.amax(torch.abs(centered), dim=1, keepdim=True), min=1.0)
    logits = torch.where(m > 0, torch.log(torch.clamp(a, _EPS, 1.0)) - scale * centered,
                         torch.full((), float("-inf"), device=a.device))
    new = torch.softmax(logits, dim=1) * m
    return new / torch.clamp(torch.sum(new, dim=1, keepdim=True), min=_EPS)


def eg_iterate(states: Tensor, target: Tensor, mask: Tensor, num_steps: int,
               step_size: float, step) -> Tensor:
    """The P1 iteration with ``step`` as its EG step (``eg_step_ref``, or the
    ``eg_step`` kernel on the card), the two products in full f32, from
    ``mask / max(sum mask, 1)``: alpha ``[R, D]`` from mask ``[R, D]`` over
    states ``[D, K]`` shared by every row, or ``[R, D, K]``, a row's own, and
    target ``[K]`` (or ``[R, K]``); with a seed axis, alpha ``[S, R, D]`` from
    mask ``[S, R, D]`` over states ``[S, D, K]`` shared by the rows of a seed,
    target ``[S, K]``. A row with an empty mask is what ``step`` gives it
    (NaN by ``eg_step_ref``, 0 by the kernel)."""
    s = states.to(torch.float32)
    m = mask.to(torch.float32)
    alpha = m / torch.clamp(torch.sum(m, dim=-1, keepdim=True), min=1.0)
    log_g = torch.log(torch.clamp(target.to(torch.float32), min=_EPS))
    per_row = s.dim() == 3 and m.dim() == 2
    if m.dim() == 3:                    # a seed axis: all its rows in one, each with its seed's g
        log_g = log_g.repeat_interleave(m.shape[1], dim=0)
        alpha, m = alpha.reshape(-1, m.shape[-1]), m.reshape(-1, m.shape[-1])
    m = m.contiguous()
    with full_f32_matmul():
        for _ in range(num_steps):
            # [rows, K] mixed states, then [rows, D] dKL/dalpha
            if per_row:
                u = torch.clamp(torch.bmm(alpha.unsqueeze(1), s).squeeze(1), min=_EPS)
                grad = torch.bmm(s, (torch.log(u) - log_g + 1.0).unsqueeze(-1)).squeeze(-1)
            else:
                u = torch.clamp(_seedwise(alpha, s), min=_EPS)
                grad = _seedwise(torch.log(u) - log_g + 1.0, s.transpose(-2, -1))
            alpha = step(alpha, grad, m, step_size=step_size)
    return alpha.reshape(mask.shape)


def _seedwise(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` for the rows ``a``; where ``b`` has a seed axis ``[S, D, K]``,
    ``a`` holds seed 0's rows, then seed 1's, ..., and each seed takes a
    product of its own: the very one a single run of it takes (a batched
    product may round otherwise, and the solve carries that from step to
    step)."""
    if b.dim() == 2:
        return a @ b
    return torch.cat([x @ y for x, y in zip(a.reshape(len(b), -1, a.shape[-1]), b)])


def _zero_empty_rows(alpha: Tensor, mask: Tensor) -> Tensor:
    """0 on the rows whose mask is empty, the kernel's rule (``eg_step_ref``
    gives NaN there, and rows never mix, so the NaN stays in that row)."""
    empty = ~torch.any(mask > 0, dim=-1, keepdim=True)
    return torch.where(empty, torch.zeros((), device=alpha.device), alpha)


def eg_solve_rows_ref(states: Tensor, ids: Tensor | None, target: Tensor, mask: Tensor, *,
                      num_steps: int, step_size: float = 2.0) -> Tensor:
    """Plain version of the ``eg_solve_rows`` kernel: row r of alpha over the
    gathered ``states[ids[r]]`` (``ids`` None: ``states[:D]``), ``num_steps``
    EG steps of ``eg_step_ref`` -> alpha ``[R, D]`` f32, or ``[S, R, D]`` with
    a leading seed axis on states, ids, target and mask (row r of seed s over
    ``states[s, ids[s, r]]`` against ``target[s]``). A row with an empty mask
    is 0, the kernel's rule."""
    seeded = states.dim() == 3
    st = states if seeded else states.unsqueeze(0)
    s, n, k = st.shape
    r, d = mask.shape[-2:]
    local = (torch.arange(d, device=st.device).expand(s, r, d) if ids is None
             else ids.reshape(s, r, d).long())
    rows = local + n * torch.arange(s, device=st.device).reshape(s, 1, 1)
    gathered = st.reshape(s * n, k)[rows.reshape(s * r, d)]          # [S R, D, K]
    tgt = target.reshape(s, 1, k).expand(s, r, k).reshape(s * r, k)
    m = mask.reshape(s * r, d)
    alpha = eg_iterate(gathered, tgt, m, num_steps, step_size, eg_step_ref)
    return _zero_empty_rows(alpha, m).reshape(mask.shape)
