"""CUDA kernels over state matrices, written by hand for Hopper (sm_90a).

* ``kl_rows(states, target)`` — per-row ``D_KL(states[v] || target)`` in bits
  (``csrc/kl_rows.cu``), Eq. (9) over a whole state matrix;
* ``entropy_rows(states)`` — per-row entropy in bits
  (``csrc/entropy_rows.cu``), Eq. (8); both on the row reduction of
  ``csrc/row_stream.cuh``, whose launcher picks warps per row and rows per
  block from V and K;
* ``eg_step(alpha, grad, mask, step_size=)`` — one masked
  exponentiated-gradient step of the P1 solver per row (``csrc/eg_step.cu``);
* ``eg_solve_rows(states, ids, target, mask, num_steps=, step_size=)`` —
  every EG step of a P1 solve in one launch (``csrc/eg_solve.cu``) on an id
  table: each row of alpha stages its own rows of the states (neighbour
  lists; no table: the first D rows, dense contacts; a seed axis), where they
  fit one block's shared memory (``eg_solve_fits``, ``eg_solve_max_k``). It
  is the one-launch route of ``core.kl_solver.solve_p1_all``.

Counterparts of the Pallas kernels of ``repro.kernels.kl_simplex.kernel``.
The sources carry their design notes. They are compiled by ``nvcc`` at first
use (``kernels.build``) and bound through ``ctypes``; importing this module
needs neither a GPU nor a compiler.

Each wrapper takes CUDA tensors only and raises on anything the kernel does
not take (``ops`` routes CPU tensors to the plain versions in ``ref``). It
allocates the output with ``torch.empty``, launches on PyTorch's current
stream (the row kernels as programmatic dependent launches, which wait for
the stream's previous kernel before touching memory), does not synchronise,
raises if the launch was refused, and adds one to ``launch_counts[name]``
per launch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from .. import build as build_lib

Tensor = torch.Tensor

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "eg_step": CSRC / "eg_step.cu",
    "eg_solve": CSRC / "eg_solve.cu",
    "kl_rows": CSRC / "kl_rows.cu",
    "entropy_rows": CSRC / "entropy_rows.cu",
}

# each library's launch function
_ENTRIES = {**{name: f"{name}_launch" for name in SOURCES}, "eg_solve": "eg_solve_rows_launch"}

# launches per kernel since the last reset_launch_counts()
launch_counts: dict[str, int] = {name: 0 for name in SOURCES}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def build() -> None:
    """Compile (the four sources in parallel) and load the kernels; a no-op
    once loaded. Called by the wrappers at first launch."""
    if _LIBS:
        return
    names = list(SOURCES)
    libs = dict(zip(names, build_lib.load_libraries([SOURCES[n] for n in names])))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs["eg_step"].eg_step_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32,
                                               ctypes.c_float, i32, ptr]
    libs["eg_solve"].eg_solve_rows_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                                      i32, i32, i32, ctypes.c_float, ptr]
    libs["eg_solve"].eg_solve_fits.argtypes = [i32, i32, ctypes.POINTER(i32)]
    libs["eg_solve"].eg_solve_fits.restype = i32
    libs["eg_solve"].eg_solve_max_k.argtypes = [ctypes.POINTER(i32)]
    libs["eg_solve"].eg_solve_max_k.restype = i32
    libs["eg_solve"].eg_solve_smem_bytes.argtypes = [i32, i32]
    libs["eg_solve"].eg_solve_smem_bytes.restype = ctypes.c_longlong
    libs["kl_rows"].kl_rows_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    libs["entropy_rows"].entropy_rows_launch.argtypes = [ptr, ptr, i32, i32, i32,
                                                         ptr]
    for name, lib in libs.items():
        getattr(lib, _ENTRIES[name]).restype = i32
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
    _LIBS.update(libs)


def _check_rows(t: Tensor, what: str, name: str) -> None:
    """A ``[V, K]`` operand: CUDA, f32 or bf16, contiguous, V and K int32."""
    if not t.is_cuda:
        raise ValueError(f"{name}: {what} must be a CUDA tensor, got {t.device} "
                         "(CPU tensors go through kernels.kl_simplex.ops / ref)")
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: {what} must be float32 or bfloat16, got {t.dtype}")
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be a contiguous [V, K] tensor, got "
                         f"shape {tuple(t.shape)} stride {t.stride()}")
    if max(t.shape) >= 2 ** 31:
        raise ValueError(f"{name}: {what} of shape {tuple(t.shape)} does not fit int32")


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        text = getattr(_LIBS[name], f"{name}_error_string")(code)
        raise RuntimeError(f"{name}: launch failed with CUDA error {code} "
                           f"({text.decode() if text else '?'})")


def _launch(name: str, out: Tensor, *args) -> Tensor:
    """Launch ``name``'s kernel on the current stream of ``out``'s device."""
    build()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(_LIBS[name], _ENTRIES[name])(*args, stream)
    _raise_on(code, name)
    launch_counts[name] += 1
    return out


def kl_rows(states: Tensor, target: Tensor) -> Tensor:
    """Per-row ``D_KL(states[v] || target)`` in bits: states ``[V, K]`` f32 or
    bf16, target ``[K]`` f32 on the same device -> ``[V]`` f32. Lanes with
    ``states <= 1e-12`` contribute 0; both sides are clipped to [1e-12, 1]."""
    name = "kl_rows"
    _check_rows(states, "states", name)
    if target.device != states.device:
        raise ValueError(f"{name}: target is on {target.device}, states on "
                         f"{states.device}")
    if target.dtype != torch.float32:
        raise TypeError(f"{name}: target must be float32, got {target.dtype}")
    if target.shape != states.shape[1:] or not target.is_contiguous():
        raise ValueError(f"{name}: target must be a contiguous [K] = "
                         f"[{states.shape[1]}] tensor, got shape {tuple(target.shape)}")
    v, k = states.shape
    out = torch.empty((v,), dtype=torch.float32, device=states.device)
    if v == 0:
        return out
    return _launch(name, out, states.data_ptr(), target.data_ptr(), out.data_ptr(),
                   v, k, _DTYPE_CODE[states.dtype])


def entropy_rows(states: Tensor) -> Tensor:
    """Per-row entropy in bits: states ``[V, K]`` f32 or bf16 -> ``[V]`` f32.
    Lanes with ``states <= 1e-12`` contribute 0."""
    name = "entropy_rows"
    _check_rows(states, "states", name)
    v, k = states.shape
    out = torch.empty((v,), dtype=torch.float32, device=states.device)
    if v == 0:
        return out
    return _launch(name, out, states.data_ptr(), out.data_ptr(), v, k,
                   _DTYPE_CODE[states.dtype])


def eg_step(alpha: Tensor, grad: Tensor, mask: Tensor, *,
            step_size: float = 2.0) -> Tensor:
    """One masked exponentiated-gradient step per row: alpha, grad, mask
    ``[V, K]``, all f32 or all bf16, on one device -> ``[V, K]`` f32 on the
    simplex, exactly 0 where ``mask <= 0`` (a row with an empty mask is all
    0). ``step_size`` is a finite float."""
    name = "eg_step"
    for what, t in (("alpha", alpha), ("grad", grad), ("mask", mask)):
        _check_rows(t, what, name)
        if t.device != alpha.device:
            raise ValueError(f"{name}: {what} is on {t.device}, alpha on {alpha.device}")
        if t.dtype != alpha.dtype:
            raise TypeError(f"{name}: {what} is {t.dtype}, alpha {alpha.dtype}: "
                            "the three operands share one dtype")
        if t.shape != alpha.shape:
            raise ValueError(f"{name}: {what} {tuple(t.shape)} and alpha "
                             f"{tuple(alpha.shape)} differ in shape")
    step = float(step_size)
    if not math.isfinite(step):
        raise ValueError(f"{name}: step_size must be finite, got {step_size}")
    v, k = alpha.shape
    out = torch.empty((v, k), dtype=torch.float32, device=alpha.device)
    if v == 0:
        return out
    return _launch(name, out, alpha.data_ptr(), grad.data_ptr(), mask.data_ptr(),
                   out.data_ptr(), v, k, step, _DTYPE_CODE[alpha.dtype])


def _device_query(fn_name: str, *args, device=None) -> int:
    """Call an ``eg_solve_*`` query of the library on ``device`` (the current
    CUDA device when None) and return the value it wrote; raises on a CUDA
    error. Builds the kernels on first use."""
    build()
    value = ctypes.c_int(0)
    with torch.cuda.device(device):
        code = getattr(_LIBS["eg_solve"], fn_name)(*args, ctypes.byref(value))
    _raise_on(code, "eg_solve")
    return value.value


def eg_solve_fits(d: int, k: int, device=None) -> bool:
    """Whether ``eg_solve_rows`` takes ``[d, k]`` states per row of alpha on
    ``device``: they fit one block's shared memory there (builds
    the kernels on first use). The answer is kept per (d, k, device), so that
    a route by shape costs the host a dictionary look-up."""
    index = None if device is None else torch.device(device).index
    return _fits(int(d), int(k), torch.cuda.current_device() if index is None else index)


@functools.lru_cache(maxsize=256)
def _fits(d: int, k: int, index: int) -> bool:
    return bool(_device_query("eg_solve_fits", d, k, device=index))


def eg_solve_max_k(device=None) -> int:
    """The largest K for which ``eg_solve_rows`` takes a ``[K, K]`` state
    matrix on ``device`` (builds the kernels on first use)."""
    return _device_query("eg_solve_max_k", device=device)


def eg_solve_smem_bytes(d: int, k: int) -> int:
    """Shared memory one block of ``eg_solve_rows`` takes for a ``[d, k]`` state
    matrix (builds the kernels on first use)."""
    build()
    return int(_LIBS["eg_solve"].eg_solve_smem_bytes(d, k))


def eg_solve_rows(states: Tensor, ids: Tensor | None, target: Tensor, mask: Tensor, *,
                  num_steps: int, step_size: float = 2.0) -> Tensor:
    """Every exponentiated-gradient step of a P1 solve in one launch: row r of
    alpha solves P1 over its own ``D`` candidate rows of the states,
    ``states[ids[r]]``.

    ``states`` ``[N, K]``, ``ids`` ``[R, D]`` int32 in ``[0, N)`` (or None: the
    identity, every row over ``states[:D]``), ``target`` ``[K]``, ``mask``
    ``[R, D]`` (0/1 contacts), f32 but the ids, contiguous, on one device ->
    alpha ``[R, D]`` f32 after ``num_steps`` steps from ``mask / max(sum
    mask, 1)``, rows on the simplex, exactly 0 off the mask (a row with an
    empty mask is all 0). With a leading seed axis
    (``states`` ``[S, N, K]``, ``ids`` / ``mask`` ``[S, R, D]``, ``target``
    ``[S, K]``) row r of seed s reads ``states[s, ids[s, r]]`` and
    ``target[s]`` -> ``[S, R, D]``. Padding slots (the row's own id with
    mask 0, as ``core.contacts`` lays them out) are staged and get alpha 0.
    The ids are not checked on the device: one out of range reads another
    seed's rows or memory past the states. Raises on a shape that does not
    fit one block (``eg_solve_fits(D, K)``)."""
    name = "eg_solve"
    seeded = states.dim() == 3
    want = 3 if seeded else 2
    for what, t in (("states", states), ("ids", ids), ("target", target), ("mask", mask)):
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: {what} must be a CUDA tensor, got {t.device} "
                             "(CPU tensors go through kernels.kl_simplex.ref)")
        if t.device != states.device:
            raise ValueError(f"{name}: {what} is on {t.device}, states on {states.device}")
        if t.dtype != (torch.int32 if what == "ids" else torch.float32):
            raise TypeError(f"{name}: {what} must be "
                            f"{'int32' if what == 'ids' else 'float32'}, got {t.dtype}")
        if t.dim() != (want - 1 if what == "target" else want) or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous "
                             f"{'[S, ...]' if seeded else 'un-seeded'} tensor of "
                             f"{want - 1 if what == 'target' else want} dims, got shape "
                             f"{tuple(t.shape)} stride {t.stride()}")
    s = states.shape[0] if seeded else 1
    n, k = states.shape[-2:]
    r, d = mask.shape[-2:]
    if (seeded and (mask.shape[0] != s or target.shape[0] != s)) or target.shape[-1] != k:
        raise ValueError(f"{name}: target {tuple(target.shape)} and mask "
                         f"{tuple(mask.shape)} do not match states {tuple(states.shape)}")
    if ids is not None and ids.shape != mask.shape:
        raise ValueError(f"{name}: ids {tuple(ids.shape)} and mask {tuple(mask.shape)} "
                         "differ in shape")
    if ids is None and d > n:
        raise ValueError(f"{name}: the identity table takes D <= N, got D = {d}, N = {n}")
    if max(s * r, n, k) >= 2 ** 31:
        raise ValueError(f"{name}: a shape of {tuple(states.shape)} / {tuple(mask.shape)} "
                         "does not fit int32")
    if int(num_steps) != num_steps or num_steps < 0:
        raise ValueError(f"{name}: num_steps must be an integer >= 0, got {num_steps}")
    step = float(step_size)
    if not math.isfinite(step):
        raise ValueError(f"{name}: step_size must be finite, got {step_size}")
    if not eg_solve_fits(d, k, states.device):
        raise ValueError(
            f"{name}: [{d}, {k}] states per row do not fit one block "
            f"({eg_solve_smem_bytes(d, k)} B of shared memory): core.kl_solver takes the "
            "loop of ref.eg_iterate there")
    out = torch.empty(mask.shape, dtype=torch.float32, device=states.device)
    if s * r == 0:
        return out
    return _launch(name, out, states.data_ptr(), None if ids is None else ids.data_ptr(),
                   target.data_ptr(), mask.data_ptr(), out.data_ptr(), s, r, n, d, k,
                   int(num_steps), step)
