"""CUDA kernels over state matrices: the KL / entropy diagnostics, the fused
exponentiated-gradient step of the P1 solver and the whole P1 solve in one
launch, on a shared state matrix or on an id table."""
from .kernel import (eg_solve, eg_solve_rows, eg_step,  # noqa: F401
                     entropy_rows as entropy_rows_kernel, kl_rows as kl_rows_kernel)
from .ops import entropy_rows, kl_rows, solve_p1_all_fused  # noqa: F401
from .ref import (eg_solve_ref, eg_solve_rows_ref, eg_step_ref,  # noqa: F401
                  entropy_rows_ref, kl_rows_ref)
