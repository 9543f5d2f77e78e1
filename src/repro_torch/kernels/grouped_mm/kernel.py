"""Grouped (ragged) matrix products written by hand for Hopper (sm_90a), on
group offsets that live on the device (``csrc/grouped_mm.cu``, design note
there).

Not the port of a Pallas kernel: the port of ``jax.lax.ragged_dot``, which
the reference's ``moe_ragged`` leaves to XLA. Bound by operations at the
MoE's prefill shapes (hundreds of flops per byte), by bytes in decode. The
design: one persistent launch per product whose blocks walk a tile schedule
built on the device from ``offsets`` (``tile_schedule`` mirrors it here); a
shared-memory ring filled by TMA a few k-steps ahead (guarded element loads
for an operand whose rows are not 16-byte aligned); bf16 on ``wgmma``
(128 x 256 tiles), f32 as 3xTF32 on ``mma.sync`` (64 x 256 tiles). Compiled by
``nvcc`` at first use (``kernels.build``) and bound through ``ctypes``;
importing this module needs neither a GPU nor a compiler.

Both wrappers take contiguous CUDA tensors only (f32 or bf16, one dtype;
``offsets`` int32 ``[E + 1]`` with ``E <= MAX_GROUPS``; every extent below
2^31) and raise on anything else. Each allocates its output with
``torch.empty``, launches on PyTorch's current stream, does not synchronise,
raises if the launch was refused, and adds one to ``launch_counts`` per
launch. ``ops`` registers them as the custom ops ``repro_torch::grouped_mm``
/ ``repro_torch::grouped_mm_wgrad`` with their gradient, shapes on meta
tensors and flop counts.
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
# a block's output tile (BM x BN) and reduction slice per stage (BK), per
# dtype: csrc's Tile<T>
BLOCK_TILE = {torch.float32: (64, 256, 32), torch.bfloat16: (128, 256, 64)}
MAX_GROUPS = 1024       # csrc kMaxGroups: the prefix of row tiles in shared memory
_MODES = {"forward": 0, "trans": 1, "wgrad": 2}
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
    lib.grouped_mm_grid.argtypes = [i32] * 6
    lib.grouped_mm_grid.restype = ctypes.c_longlong
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


def _check_groups(name: str, e: int) -> None:
    if e > MAX_GROUPS:
        raise ValueError(f"{name}: E = {e} groups, the kernel takes at most {MAX_GROUPS}")


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
    _check_groups(name, e)
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
    _check_groups(name, e)
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


# ------------------------------------------------------ the tile schedule ----

def grid_bound(m: int, k: int, n: int, e: int, dtype: torch.dtype, wgrad: bool = False) -> int:
    """The bound on a launch's tiles that needs only the shapes (the launch's
    grid is the card's SM count times the blocks an SM holds, capped by it):
    ``(ceil(M/BM) + E) * ceil(N/BN)`` forward, ``E * ceil(K/BM) * ceil(N/BN)``
    for wgrad."""
    bm, bn, _ = BLOCK_TILE[dtype]
    tn = -(-n // bn)
    return e * -(-k // bm) * tn if wgrad else (-(-m // bm) + e) * tn


def tile_schedule(offsets, m: int, k: int, n: int, dtype: torch.dtype,
                  wgrad: bool = False) -> dict:
    """The tiles the kernel walks for these offsets, in the order of its tile
    index: a plain mirror of the device's enumeration (tests and
    ``chip_smoke.py``'s report only). Forward: ``(e, r0, r_end, c0)`` per tile,
    rows ``[r0, r_end)`` of group e and columns ``[c0, c0 + BN)``, group by
    group, and ``zero_rows``, the row ranges in no group that the launch
    zeroes. wgrad: ``(e, i0, j0, lo, hi)``, the tile at ``dw[e, i0:, j0:]``
    reduced over rows ``[lo, hi)`` (none: zeros), the groups largest first
    (ties by index). Block b of a grid of G takes index r * G + b in even
    rounds r and r * G + G - 1 - b in odd ones. Group bounds are clamped as
    the kernel and the plain version clamp them."""
    bm, bn, _ = BLOCK_TILE[dtype]
    offs = [int(o) for o in (offsets.tolist() if hasattr(offsets, "tolist") else offsets)]
    e = len(offs) - 1
    bounds = []
    for g in range(e):
        lo = min(max(offs[g], 0), m)
        bounds.append((lo, min(max(offs[g + 1], lo), m)))
    tn = -(-n // bn)
    tiles = []
    if wgrad:
        for g in sorted(range(e), key=lambda g: (bounds[g][0] - bounds[g][1], g)):
            lo, hi = bounds[g]
            for i0 in range(0, -(-k // bm) * bm, bm):
                tiles.extend((g, i0, j0, lo, hi) for j0 in range(0, tn * bn, bn))
        zero_rows = []
    else:
        for g, (lo, hi) in enumerate(bounds):
            for r0 in range(lo, hi, bm):
                tiles.extend((g, r0, min(r0 + bm, hi), c0) for c0 in range(0, tn * bn, bn))
        first = min(max(offs[0], 0), m)
        last = min(max(offs[-1], first), m)
        zero_rows = [(lo, hi) for lo, hi in ((0, first), (last, m)) if hi > lo]
    return {"tiles": tiles, "count": len(tiles), "zero_rows": zero_rows,
            "bound": grid_bound(m, k, n, e, dtype, wgrad)}


def launch_grid(m: int, k: int, n: int, e: int, dtype: torch.dtype, mode: str = "forward") -> int:
    """The grid (blocks) a launch of these shapes takes on the current CUDA
    device (``mode``: ``forward``, ``trans`` or ``wgrad``); launches nothing."""
    build()
    grid = _LIBS["grouped_mm"].grouped_mm_grid(m, k, n, e, _MODES[mode], _DTYPE_CODE[dtype])
    if grid < 0:
        _raise_on(int(-grid), "grouped_mm_grid")
    return int(grid)
