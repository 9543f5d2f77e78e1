"""Operations and bytes of the MoE's grouped products, as the algorithm
needs them: ``y[M, N] = x[M, K] @ w[e]`` over row groups (forward, and the
input gradient with ``w`` transposed) and ``dw[E, K, N] = x^T dy`` (the
weight gradient). Each input byte and each output byte counted once."""

from . import peaks


def product(m: int, k: int, n: int, experts: int, itemsize: int) -> tuple[float, float]:
    """``(operations, bytes)`` of one grouped product or weight gradient:
    2 M K N operations; M K + M N + E K N elements moved (the offsets'
    E + 1 int32 besides)."""
    flops = 2.0 * m * k * n
    nbytes = itemsize * (m * k + m * n + experts * k * n) + 4 * (experts + 1)
    return flops, nbytes


def launches_per_vehicle_step(cfg: dict) -> tuple[int, int]:
    """Launches of one vehicle's training step with remat: per layer the
    SwiGLU's three products forward, again in the recompute, and their three
    input gradients; three weight gradients."""
    L = cfg["num_hidden_layers"]
    return 9 * L, 3 * L


def least_seconds_per_launch(cfg: dict, tokens: int, itemsize: int, precision: str) -> float:
    """Every launch of a step moves the same bytes and does the same
    operations: M = tokens x top_k rows against one d x f or f x d stack."""
    m = tokens * cfg["num_experts_per_tok"]
    flops, nbytes = product(m, cfg["hidden_size"], cfg["intermediate_size"],
                            cfg["num_local_experts"], itemsize)
    return peaks.least_seconds(flops, nbytes, precision)
