"""Grouped (ragged) products on device-side group offsets: the hand-written
Hopper kernels, their plain versions and the custom ops the MoE calls."""
from .ops import grouped_mm, grouped_mm_op, grouped_mm_wgrad_op  # noqa: F401
from .ref import grouped_mm_ref, grouped_mm_wgrad_ref  # noqa: F401
