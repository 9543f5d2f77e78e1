"""AdamW written by hand for Hopper (sm_90a): one in-place launch over a
table of up to ``max_leaves()`` f32 leaves (``csrc/adamw.cu``, design note
there).

* ``adamw_(params, grads, mu, nu, c1, c2, *, lr, b1, b2, eps, weight_decay)``
  — for every leaf i, ``mu[i]``, ``nu[i]`` and ``params[i]`` take one AdamW
  step on ``grads[i]`` in place, the bias corrections read from the 0-d f32
  tensors ``c1`` / ``c2`` on the device: the same bits as ``optim.adamw``
  followed by ``apply_updates``.

Not the port of a Pallas kernel: the reference leaves AdamW to XLA. It
replaces the port's eager ``optim.adamw`` on the train step's main path.
Compiled by ``nvcc`` at first use (``kernels.build``) and bound through
``ctypes``; importing this module needs neither a GPU nor a compiler.

The wrapper takes plain CUDA tensors only and raises on anything the kernel
does not take (``check_leaves``): a DTensor goes as its ``to_local()``, and
CPU and ``meta`` tensors go through ``launch.steps.adamw_per_leaf_``, which
is the kernel's plain version. It launches on PyTorch's current stream, once
per ``max_leaves()`` leaves, does not synchronise, raises if a launch was
refused, and adds one to ``launch_counts["adamw"]`` per launch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build as build_lib

Tensor = torch.Tensor

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"adamw": CSRC / "adamw.cu"}

# launches per kernel since the last reset_launch_counts()
launch_counts: dict[str, int] = {"adamw": 0}

_INVALID_VALUE = 1   # cudaErrorInvalidValue: the launcher refused its arguments
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def build() -> None:
    """Compile and load the kernel; a no-op once loaded. Called by the
    wrapper at first launch."""
    if _LIBS:
        return
    (lib,) = build_lib.load_libraries([SOURCES["adamw"]])
    ptrs, f32 = ctypes.POINTER(ctypes.c_void_p), ctypes.c_float
    lib.adamw_launch.argtypes = [ptrs, ptrs, ptrs, ptrs, ctypes.POINTER(ctypes.c_longlong),
                                 ctypes.c_int, *[f32] * 7, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.adamw_launch.restype = ctypes.c_int
    lib.adamw_max_leaves.argtypes = []
    lib.adamw_max_leaves.restype = ctypes.c_int
    lib.adamw_error_string.argtypes = [ctypes.c_int]
    lib.adamw_error_string.restype = ctypes.c_char_p
    _LIBS["adamw"] = lib


def max_leaves() -> int:
    """Leaves one launch takes (the size of the table in the kernel's
    parameters; builds the kernel on first use)."""
    build()
    return _LIBS["adamw"].adamw_max_leaves()


def check_leaves(params: list, grads: list, mu: list, nu: list) -> torch.device:
    """The leaves of one step, on any device: four lists of one length, each
    leaf's four tensors plain (not a subclass such as a DTensor), contiguous
    f32 of one shape, every tensor on one device (returned). Raises
    ``ValueError`` / ``TypeError`` otherwise."""
    name = "adamw"
    if not len(params) == len(grads) == len(mu) == len(nu):
        raise ValueError(f"{name}: {len(params)} params, {len(grads)} grads, {len(mu)} mu "
                         f"and {len(nu)} nu")
    device = params[0].device if params else None
    for i, leaf in enumerate(zip(params, grads, mu, nu)):
        for what, x in zip(("param", "grad", "mu", "nu"), leaf):
            if type(x) is not Tensor:
                raise TypeError(f"{name}: leaf {i}'s {what} is a {type(x).__name__}, not a "
                                "plain tensor (a DTensor goes as its to_local())")
            if x.dtype != torch.float32:
                raise TypeError(f"{name}: leaf {i}'s {what} is {x.dtype}, not float32")
            if x.device != device:
                raise ValueError(f"{name}: leaf {i}'s {what} is on {x.device}, the first "
                                 f"param on {device}")
            if x.shape != leaf[0].shape:
                raise ValueError(f"{name}: leaf {i}'s {what} is {tuple(x.shape)}, its param "
                                 f"{tuple(leaf[0].shape)}")
            if not x.is_contiguous():
                raise ValueError(f"{name}: leaf {i}'s {what} is not contiguous (stride "
                                 f"{x.stride()})")
    return device


def adamw_(params: list, grads: list, mu: list, nu: list, c1: Tensor, c2: Tensor, *,
           lr: float, b1: float, b2: float, eps: float, weight_decay: float) -> None:
    """One AdamW step of every leaf in place (module docstring): CUDA leaves
    (``check_leaves``), ``c1`` / ``c2`` one f32 element each on their device.
    Leaves without an element are skipped; the rest go in launches of
    ``max_leaves()``."""
    name = "adamw"
    device = check_leaves(params, grads, mu, nu)
    if device is None:
        return
    if device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {device} (CPU and meta "
                         "tensors go through launch.steps.adamw_per_leaf_)")
    for what, c in (("c1", c1), ("c2", c2)):
        if c.device != device or c.dtype != torch.float32 or c.numel() != 1:
            raise ValueError(f"{name}: {what} must be one float32 element on {device}, got "
                             f"{c.dtype} {tuple(c.shape)} on {c.device}")
    build()
    launch, step = _LIBS[name].adamw_launch, max_leaves()
    scalars = (b1, 1 - b1, b2, 1 - b2, eps, weight_decay, -lr)
    live = [i for i, p in enumerate(params) if p.numel() > 0]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for start in range(0, len(live), step):
            ids = live[start:start + step]
            n = len(ids)
            table = [(ctypes.c_void_p * n)(*(leaves[i].data_ptr() for i in ids))
                     for leaves in (params, grads, mu, nu)]
            code = launch(*table, (ctypes.c_longlong * n)(*(params[i].numel() for i in ids)),
                          n, *scalars, c1.data_ptr(), c2.data_ptr(), stream)
            if code == _INVALID_VALUE:
                raise ValueError(f"{name}: launch refused: a written tensor (param, mu, nu) "
                                 "overlaps another tensor of the step, or an argument the "
                                 "kernel does not take")
            if code != 0:
                text = _LIBS[name].adamw_error_string(code)
                raise RuntimeError(f"{name}: launch failed with CUDA error {code} "
                                   f"({text.decode() if text else '?'})")
            launch_counts[name] += 1
