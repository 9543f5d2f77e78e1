"""CUDA kernels over state matrices: the KL / entropy diagnostics, the fused
exponentiated-gradient step of the P1 solver and the whole P1 solve in one
launch on an id table, each beside its plain version."""
from .kernel import (eg_solve_rows, eg_step,  # noqa: F401
                     entropy_rows as entropy_rows_kernel, kl_rows as kl_rows_kernel)
from .ops import entropy_rows, kl_rows  # noqa: F401
from .ref import (eg_solve_rows_ref, eg_step_ref, entropy_rows_ref,  # noqa: F401
                  kl_rows_ref)
