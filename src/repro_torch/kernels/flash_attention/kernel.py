"""Flash attention written by hand for Hopper (sm_90a): forward-only blocked
online-softmax attention with GQA, causal and sliding-window masking, on the
tensor cores (bf16 ``mma.sync``; f32 by 3xTF32) (``csrc/flash_attention.cu``,
design note there); and the causal training attention, forward with the rows'
log-sum-exp and backward, bf16 operands with f32 sums
(``csrc/flash_train.cu``, design note there), as the autograd function
``flash_train_attention``.

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

``flash_train_attention`` takes bf16 CUDA q [B, S, H, dqk], k [B, S, KV, dqk],
v [B, S, KV, dv] at a width pair of ``TRAIN_WIDTHS``, rows on 16-byte
boundaries as above, and raises on anything else. Its forward is one
``flash_train_fwd`` launch (o, and the f32 log-sum-exp it saves), its backward
one ``flash_train_dq`` (dQ and D = rowsum(dO o)) then one ``flash_train_dkdv``
launch; each adds one to its key of ``launch_counts``. Its gradients are the
same bits from run to run (no atomics). ``train_takes`` says which inputs it
takes: the route of ``ops.make_train_attn_impl``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build as build_lib

Tensor = torch.Tensor

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"flash_attention": CSRC / "flash_attention.cu",
           "flash_train": CSRC / "flash_train.cu"}

HEAD_DIMS = (16, 32, 64, 128)   # the template instantiations of the serving kernel
# (q/k width, v width) of the training kernels' instantiations
TRAIN_WIDTHS = ((64, 64), (128, 128), (192, 128))

# launches per kernel since the last reset_launch_counts()
launch_counts: dict[str, int] = {"flash_attention": 0, "flash_train_fwd": 0,
                                 "flash_train_dq": 0, "flash_train_dkdv": 0}

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
    lib, train = build_lib.load_libraries([SOURCES["flash_attention"], SOURCES["flash_train"]])
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
    train.flash_train_launch.argtypes = (
        [i32] + [ptr] * 10 + [i32] * 4 + [i64] * 9 + [ctypes.c_float, i32, i32, i32, i32, ptr])
    train.flash_train_launch.restype = i32
    train.flash_train_error_string.argtypes = [i32]
    train.flash_train_error_string.restype = ctypes.c_char_p
    _LIBS["flash_attention"] = lib
    _LIBS["flash_train"] = train


def block_resources(hd: int, dtype: torch.dtype, group: int) -> dict:
    """What one block of the kernel takes for this head_dim, dtype and GQA
    group: q-heads per block, threads, shared memory in bytes (builds the
    kernel on first use)."""
    build()
    lib = _LIBS["flash_attention"]
    heads = lib.flash_attention_heads_per_block(group)
    return {"heads_per_block": heads, "threads": 128 * heads,
            "smem_bytes": lib.flash_attention_smem_bytes(hd, _DTYPE_CODE[dtype], group)}


def _check_rows(name: str, tensors, dtypes: tuple) -> None:
    """Device, dtype, rank and row alignment of each (what, tensor) pair."""
    q = tensors[0][1]
    for what, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: {what} must be a CUDA tensor, got {t.device} "
                             "(CPU tensors go through kernels.flash_attention.ops / ref)")
        if t.device != q.device:
            raise ValueError(f"{name}: {what} is on {t.device}, q on {q.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {what} must be "
                            f"{' or '.join(str(d).split('.')[-1] for d in dtypes)}, "
                            f"got {t.dtype}")
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


def _check(q: Tensor, k: Tensor, v: Tensor) -> None:
    name = "flash_attention"
    _check_rows(name, (("q", q), ("k", k), ("v", v)), tuple(_DTYPE_CODE))
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


# ------------------------------------------------------------- training ----

def train_takes(q: Tensor, k: Tensor, v: Tensor) -> bool:
    """Whether ``flash_train_attention`` takes these inputs, by what they show:
    plain CUDA tensors (no DTensor or other subclass), all bf16, 4-D, q and k
    of one width and (that width, v's) one of ``TRAIN_WIDTHS``."""
    return (all(type(t) is Tensor and t.is_cuda and t.dtype == torch.bfloat16 and t.dim() == 4
                for t in (q, k, v))
            and k.shape[-1] == q.shape[-1] and (q.shape[-1], v.shape[-1]) in TRAIN_WIDTHS)


def _check_train(q: Tensor, k: Tensor, v: Tensor, window: int | None) -> None:
    name = "flash_train_attention"
    _check_rows(name, (("q", q), ("k", k), ("v", v)), (torch.bfloat16,))
    b, s, h, dqk = q.shape
    if k.shape[:2] != (b, s) or v.shape[:3] != k.shape[:3] or k.shape[3] != dqk:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "k must be [B, S, KV, dqk] and v [B, S, KV, dv] for q [B, S, H, dqk]")
    kv = k.shape[2]
    if kv == 0 or h % kv:
        raise ValueError(f"{name}: {h} q-heads are not a multiple of {kv} kv-heads")
    if (dqk, v.shape[3]) not in TRAIN_WIDTHS:
        raise ValueError(f"{name}: widths (q/k {dqk}, v {v.shape[3]}) are not one of "
                         f"{TRAIN_WIDTHS}")
    if b * h >= 2 ** 31 or -(-s // 64) > 65_535:
        raise ValueError(f"{name}: batch x heads {b * h} or length {s} exceed the grid")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window {window} keeps no key (a row keeps itself at 1)")


def _launch_train(pass_: int, q: Tensor, k: Tensor, v: Tensor, o, dout, out, dk, dv,
                  lse: Tensor, dsum, window: int | None, scale: float) -> None:
    b, s, h, dqk = q.shape
    # a window past S + 1 keeps every causal key
    win = 0 if window is None else min(int(window), s + 1)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    build()
    lib = _LIBS["flash_train"]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_train_launch(
            pass_, q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(o), ptr(dout), ptr(out),
            ptr(dk), ptr(dv), lse.data_ptr(), ptr(dsum), b, s, h,
            k.shape[2], q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
            k.stride(2), v.stride(0), v.stride(1), v.stride(2), scale, int(window is not None),
            win, dqk, v.shape[3], stream)
    if code != 0:
        text = lib.flash_train_error_string(code)
        raise RuntimeError(f"flash_train_attention: launch failed with CUDA error {code} "
                           f"({text.decode() if text else '?'})")
    launch_counts[("flash_train_fwd", "flash_train_dq", "flash_train_dkdv")[pass_]] += 1


def flash_train_forward(q: Tensor, k: Tensor, v: Tensor, *, window: int | None = None,
                        scale: float | None = None) -> tuple[Tensor, Tensor]:
    """The causal forward: ``(o [B, S, H, dv] bf16, lse [B, H, S] f32)``,
    lse the natural log-sum-exp of each row's kept scaled scores."""
    _check_train(q, k, v, window)
    b, s, h, dqk = q.shape
    scale = dqk ** -0.5 if scale is None else float(scale)
    o = torch.empty((b, s, h, v.shape[3]), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if o.numel():
        _launch_train(0, q, k, v, None, None, o, None, None, lse, None, window, scale)
    return o, lse


def flash_train_backward(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor, dout: Tensor,
                         *, window: int | None = None,
                         scale: float | None = None) -> tuple[Tensor, Tensor, Tensor]:
    """``(dq, dk, dv)`` in bf16, shaped as q, k, v (contiguous), from the
    forward's ``o`` and ``lse`` and the output's gradient ``dout``: one
    ``flash_train_dq`` launch (which also writes D) and one
    ``flash_train_dkdv``."""
    _check_train(q, k, v, window)
    b, s, h, dqk = q.shape
    want = (b, s, h, v.shape[3])
    for what, t in (("o", o), ("dout", dout)):
        if (t.shape != want or t.dtype != torch.bfloat16 or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"flash_train_attention: {what} must be contiguous bf16 {want} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if (lse.shape != (b, h, s) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash_train_attention: lse must be contiguous f32 {(b, h, s)}")
    scale = dqk ** -0.5 if scale is None else float(scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    if dq.numel():
        dsum = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        _launch_train(1, q, k, v, o, dout, dq, None, None, lse, dsum, window, scale)
        _launch_train(2, q, k, v, None, dout, None, dk, dv, lse, dsum, window, scale)
    return dq, dk, dv


class _FlashTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window, scale):
        o, lse = flash_train_forward(q, k, v, window=window, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.scale = window, scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd's gradient of o may come as any layout: the kernels read it
        # contiguous
        dq, dk, dv = flash_train_backward(q, k, v, o, lse, dout.contiguous(),
                                          window=ctx.window, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_train_attention(q: Tensor, k: Tensor, v: Tensor, *, window: int | None = None,
                          scale: float | None = None) -> Tensor:
    """Causal (+ ``window``) attention with its gradient on the card: q [B, S,
    H, dqk], k [B, S, KV, dqk], v [B, S, KV, dv], bf16, (dqk, dv) in
    ``TRAIN_WIDTHS``; returns o [B, S, H, dv] bf16. Raises on anything else."""
    return _FlashTrain.apply(q, k, v, window, scale)
