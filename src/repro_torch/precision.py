"""Numerical precision settings shared by the port's f32 paths."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32_matmul():
    """Run with f32 matrix products in full f32 on CUDA (no TF32): the 1e-5
    mixing / P1 tolerances against the reference do not hold otherwise. The
    caller's setting is restored on exit."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
