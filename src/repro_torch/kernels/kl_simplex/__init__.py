"""CUDA kernels over state matrices: the KL / entropy diagnostics, the fused
exponentiated-gradient step of the P1 solver and the whole P1 solve in one
launch."""
from .kernel import (eg_solve, eg_step, entropy_rows as entropy_rows_kernel,  # noqa: F401
                     kl_rows as kl_rows_kernel)
from .ops import entropy_rows, kl_rows, solve_p1_all_fused  # noqa: F401
from .ref import eg_solve_ref, eg_step_ref, entropy_rows_ref, kl_rows_ref  # noqa: F401
