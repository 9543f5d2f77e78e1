"""Grouped (ragged) matrix products written by hand for Hopper (sm_90a), on
group offsets that live on the device (``csrc/grouped_mm.cu``, design note
there).

Not the port of a Pallas kernel: the port of ``jax.lax.ragged_dot``, which
the reference's ``moe_ragged`` leaves to XLA. Compiled by ``nvcc`` at first
use (``kernels.build``) and bound through ``ctypes``; importing this module
needs neither a GPU nor a compiler.

Both wrappers take contiguous CUDA tensors only (f32 or bf16, one dtype;
``offsets`` int32 ``[E + 1]``) and raise on anything else. Each allocates its
output with ``torch.empty``, launches on PyTorch's current stream, does not
synchronise, raises if the launch was refused, and adds one to
``launch_counts`` per launch. ``ops`` registers them as the custom ops
``repro_torch::grouped_mm`` / ``repro_torch::grouped_mm_wgrad`` with their
gradient, shapes on meta tensors and flop counts.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build as build_lib

Tensor = torch.Tensor

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"grouped_mm": CSRC / "grouped_mm.cu"}

# launches per kernel since the last reset_launch_counts()
launch_counts: dict[str, int] = {"grouped_mm": 0, "grouped_mm_wgrad": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64              # output tile of a block (csrc kTile)
_GRID_LIMIT = 65_535    # grid.y and grid.z
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def build() -> None:
    """Compile and load the kernels; a no-op once loaded."""
    if _LIBS:
        return
    (lib,) = build_lib.load_libraries([SOURCES["grouped_mm"]])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.grouped_mm_launch.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    lib.grouped_mm_launch.restype = i32
    lib.grouped_mm_wgrad_launch.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    lib.grouped_mm_wgrad_launch.restype = i32
    lib.grouped_mm_error_string.argtypes = [i32]
    lib.grouped_mm_error_string.restype = ctypes.c_char_p
    _LIBS["grouped_mm"] = lib


def _check(name: str, offsets: Tensor, **tensors: Tensor) -> None:
    first = next(iter(tensors.values()))
    for what, t in {**tensors, "offsets": offsets}.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {what} must be a CUDA tensor, got {t.device} "
                             "(CPU tensors go through kernels.grouped_mm.ops / ref)")
        if t.device != first.device:
            raise ValueError(f"{name}: {what} is on {t.device}, not {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous, got stride {t.stride()}")
        if what == "offsets":
            continue
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name}: {what} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != first.dtype:
            raise TypeError(f"{name}: {what} is {t.dtype}, not {first.dtype}: one dtype")
        if max(t.shape, default=0) >= 2 ** 31:
            raise ValueError(f"{name}: {what} {tuple(t.shape)} has an extent past int32")
    if offsets.dtype != torch.int32 or offsets.dim() != 1 or offsets.numel() < 1:
        raise ValueError(f"{name}: offsets must be a 1-D int32 tensor [E + 1], got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        text = _LIBS["grouped_mm"].grouped_mm_error_string(code)
        raise RuntimeError(f"{name}: launch failed with CUDA error {code} "
                           f"({text.decode() if text else '?'})")


def grouped_mm(x: Tensor, w: Tensor, offsets: Tensor, trans_w: bool = False) -> Tensor:
    """x [M, K]; w [E, K, N] (``trans_w``: [E, N, K], read as its per-group
    transpose); offsets [E + 1] int32, non-decreasing. Returns y [M, N] in
    x.dtype: ``y[offsets[e]:offsets[e+1]] = x[...] @ w[e]``, 0 for rows in no
    group."""
    name = "grouped_mm"
    _check(name, offsets, x=x, w=w)
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"{name}: x must be [M, K] and w [E, K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    e, k_w, n = (w.shape[0], w.shape[2], w.shape[1]) if trans_w else w.shape
    if k_w != k or offsets.numel() != e + 1:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)} "
                         f"(trans_w={trans_w}) and offsets [{offsets.numel()}] do not agree")
    if -(-n // _TILE) > _GRID_LIMIT or e + 1 > _GRID_LIMIT:
        raise ValueError(f"{name}: N = {n} or E = {e} exceeds the grid ({_GRID_LIMIT} tiles "
                         f"of {_TILE}, {_GRID_LIMIT - 1} groups)")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    if e == 0:
        return y.zero_()
    build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _LIBS["grouped_mm"].grouped_mm_launch(
            x.data_ptr(), w.data_ptr(), offsets.data_ptr(), y.data_ptr(), m, k, n, e,
            int(trans_w), _DTYPE_CODE[x.dtype], stream)
    _raise_on(code, name)
    launch_counts[name] += 1
    return y


def grouped_mm_wgrad(x: Tensor, dy: Tensor, offsets: Tensor) -> Tensor:
    """x [M, K]; dy [M, N]; offsets [E + 1] int32. Returns dw [E, K, N] in
    x.dtype, ``dw[e] = x[rows of e]^T @ dy[rows of e]`` (0 for an empty
    group)."""
    name = "grouped_mm_wgrad"
    _check(name, offsets, x=x, dy=dy)
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"{name}: x [M, K] and dy [M, N] must share M, got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    m, k = x.shape
    n, e = dy.shape[1], offsets.numel() - 1
    if -(-n // _TILE) > _GRID_LIMIT or e > _GRID_LIMIT:
        raise ValueError(f"{name}: N = {n} or E = {e} exceeds the grid")
    dw = torch.empty((e, k, n), dtype=x.dtype, device=x.device)
    if dw.numel() == 0:
        return dw
    build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _LIBS["grouped_mm"].grouped_mm_wgrad_launch(
            x.data_ptr(), dy.data_ptr(), offsets.data_ptr(), dw.data_ptr(), m, k, n, e,
            _DTYPE_CODE[x.dtype], stream)
    _raise_on(code, name)
    launch_counts[name] += 1
    return dw
