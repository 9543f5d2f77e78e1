"""Flash attention written by hand for Hopper (sm_90a): forward-only blocked
online-softmax attention with GQA, causal and sliding-window masking, on the
tensor cores (bf16 ``mma.sync``; f32 by 3xTF32) (``csrc/flash_attention.cu``,
design note there).

Counterpart of the Pallas kernel of ``repro.kernels.flash_attention.kernel``.
Compiled by ``nvcc`` at first use (``kernels.build``) and bound through
``ctypes``; importing this module needs neither a GPU nor a compiler.

``flash_attention`` takes CUDA tensors only and raises on anything the kernel
does not take (``ops.attend`` routes CPU tensors to the plain version in
``ref``). It reads q/k/v in place through their strides with 16-byte copies,
so every row of q, k and v must start on a 16-byte boundary (the data
pointer and every stride but the last, in bytes, multiples of 16); a view
that breaks this raises and is never copied in silence. It allocates the output
with ``torch.empty``, launches on PyTorch's current stream, does not
synchronise, raises if the launch was refused, and adds one to
``launch_counts["flash_attention"]`` per launch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build as build_lib

Tensor = torch.Tensor

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"flash_attention": CSRC / "flash_attention.cu"}

HEAD_DIMS = (16, 32, 64, 128)   # the template instantiations of the kernel

# launches per kernel since the last reset_launch_counts()
launch_counts: dict[str, int] = {name: 0 for name in SOURCES}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def build() -> None:
    """Compile and load the kernel; a no-op once loaded. Called by the
    wrapper at first launch."""
    if _LIBS:
        return
    (lib,) = build_lib.load_libraries([SOURCES["flash_attention"]])
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = (
        [ptr] * 4 + [i32] * 5 + [i64] * 9
        + [ctypes.c_float, i32, i32, i32, i32, i32, ptr])
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_smem_bytes.argtypes = [i32, i32, i32]
    lib.flash_attention_smem_bytes.restype = i64
    lib.flash_attention_heads_per_block.argtypes = [i32]
    lib.flash_attention_heads_per_block.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    _LIBS["flash_attention"] = lib


def block_resources(hd: int, dtype: torch.dtype, group: int) -> dict:
    """What one block of the kernel takes for this head_dim, dtype and GQA
    group: q-heads per block, threads, shared memory in bytes (builds the
    kernel on first use)."""
    build()
    lib = _LIBS["flash_attention"]
    heads = lib.flash_attention_heads_per_block(group)
    return {"heads_per_block": heads, "threads": 128 * heads,
            "smem_bytes": lib.flash_attention_smem_bytes(hd, _DTYPE_CODE[dtype], group)}


def _check(q: Tensor, k: Tensor, v: Tensor) -> None:
    name = "flash_attention"
    for what, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name}: {what} must be a CUDA tensor, got {t.device} "
                             "(CPU tensors go through kernels.flash_attention.ops / ref)")
        if t.device != q.device:
            raise ValueError(f"{name}: {what} is on {t.device}, q on {q.device}")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name}: {what} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {what} is {t.dtype}, q {q.dtype}: q, k and v "
                            "share one dtype")
        if t.dim() != 4:
            raise ValueError(f"{name}: {what} must be 4-D, got shape {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {what} must have a unit last stride, got "
                             f"stride {t.stride()}")
        esize = t.element_size()
        if t.data_ptr() % 16 or any(t.stride(d) * esize % 16 for d in range(3)
                                    if t.shape[d] > 1):
            raise ValueError(f"{name}: the rows of {what} must start on 16-byte "
                             f"boundaries (data pointer {t.data_ptr() % 16} bytes past "
                             f"one, strides {t.stride()} of {esize}-byte elements)")
    b, _, h, hd = q.shape
    if k.shape != v.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} differ in "
                         "batch or head_dim")
    kv = k.shape[2]
    if kv == 0 or h % kv:
        raise ValueError(f"{name}: {h} q-heads are not a multiple of {kv} kv-heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} is not one of {HEAD_DIMS}")
    if b * h >= 2 ** 31:
        raise ValueError(f"{name}: batch x heads = {b * h} exceeds the grid")
    if -(-q.shape[1] // 64) > 65_535 or k.shape[1] >= 2 ** 31 - 128:
        raise ValueError(f"{name}: sequence lengths {q.shape[1]}, {k.shape[1]} exceed "
                         "the grid (S <= 4,194,240) or int32")


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None) -> Tensor:
    """q: [B, S, H, hd]; k/v: [B, T, KV, hd] with H % KV == 0, hd in
    ``HEAD_DIMS``, all f32 or all bf16 on one CUDA device, any strides with
    a unit last stride and rows on 16-byte boundaries. Returns [B, S, H, hd]
    in q.dtype (contiguous).
    Causal alignment assumes q and kv start at the same absolute position
    (train / prefill)."""
    _check(q, k, v)
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else float(scale)
    # a window past [-(T + 1), S + 1] keeps what the bound keeps; clamped, the
    # kernel's q_pos - window stays inside int32
    win = 0 if window is None else max(-(t + 1), min(int(window), s + 1))
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    build()
    lib = _LIBS["flash_attention"]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t, h, kv,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), scale, int(causal),
            int(window is not None), win, hd, _DTYPE_CODE[q.dtype], stream)
    if code != 0:
        text = lib.flash_attention_error_string(code)
        raise RuntimeError(f"flash_attention: launch failed with CUDA error {code} "
                           f"({text.decode() if text else '?'})")
    launch_counts["flash_attention"] += 1
    return out
