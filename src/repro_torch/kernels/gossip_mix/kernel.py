"""CUDA kernels for the gossip mix, written by hand for Hopper (sm_90a).

* ``gossip_mix_gather_grouped(idx, w, flats)`` — ``out_l[k, p] = sum_d
  w[k, d] * flats[l][idx[k, d], p]`` for a list of leaves in one launch
  (``csrc/gossip_mix_gather.cu``), the mix under the sparse contact format;
  ``gossip_mix_gather(idx, w, flat)`` is the group of one leaf;
* ``gossip_mix_matmul_grouped(mixing, flats, out=None)`` — ``out_l = mixing
  @ flat_l`` for a list of leaves in one launch, the product computed in the
  kernel at full f32 precision (``csrc/gossip_mix_matmul.cu``), the mix under
  the dense format; ``gossip_mix_matmul(mixing, flat)`` is the group of one
  leaf. The launcher picks one of two mappings from K_out (``matmul_path``):
  tiles for the federation's K = 100, column streaming for few rows (the
  train round's vehicles), the only one that mixes in place (``out=flats``).

Both take a leading seed axis (``run_seeds``) in the same one launch:
``gossip_mix_matmul_grouped`` takes ``mixing`` ``[S, K_out, K_in]`` over
``[S, K_in, P_l]`` leaves (the seed is a grid axis of the kernel), and
``gossip_mix_gather_grouped`` takes ``[S, K_out, D]`` neighbour lists over
``[S, K_in, P_l]`` leaves (the kernel folds each row's seed into its ids,
``s * K_in + id`` over ``[S * K_in, P_l]``, as it stages them).

Counterparts of the Pallas kernels of ``repro.kernels.gossip_mix.kernel``.
The sources carry their design notes. They are compiled by ``nvcc`` at first
use (``kernels.build``) and bound through ``ctypes``; importing this module
needs neither a GPU nor a compiler.

Each wrapper takes CUDA tensors only and raises on anything the kernel does
not take (``ops.mix_params_cuda`` routes CPU tensors to the plain versions in
``ref``). It allocates the output with ``torch.empty`` (unless given
``out``), launches on PyTorch's current stream, does not synchronise, raises
if the launch was refused, and adds one to ``launch_counts[name]`` per
launch. The kernel may still be
running when the wrapper returns; its operands stay valid because PyTorch's
caching allocator reuses freed memory in stream order, and the launch is on
the current stream.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build as build_lib

Tensor = torch.Tensor

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "gossip_mix_gather": CSRC / "gossip_mix_gather.cu",
    "gossip_mix_matmul": CSRC / "gossip_mix_matmul.cu",
}

# launches per kernel since the last reset_launch_counts()
launch_counts: dict[str, int] = {name: 0 for name in SOURCES}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INVALID_VALUE = 1   # cudaErrorInvalidValue: a launcher refused its arguments
# the grouped matmul's mappings (gossip_mix_matmul_path in the source)
MATMUL_TILES, MATMUL_COLUMNS = 0, 1
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def build() -> None:
    """Compile (both sources in parallel) and load the kernels; a no-op once
    loaded. Called by the wrappers at first launch."""
    if _LIBS:
        return
    names = list(SOURCES)
    gather, matmul = build_lib.load_libraries([SOURCES[n] for n in names])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    gather.gossip_mix_gather_grouped_launch.argtypes = [
        ptr, ptr, ctypes.POINTER(ptr), ctypes.POINTER(ptr),
        ctypes.POINTER(ctypes.c_longlong), i32, i32, i32, i32, i32, i32, ptr]
    gather.gossip_mix_gather_grouped_launch.restype = i32
    gather.gossip_mix_gather_error_string.argtypes = [i32]
    gather.gossip_mix_gather_error_string.restype = ctypes.c_char_p
    matmul.gossip_mix_matmul_grouped_launch.argtypes = [
        ptr, ctypes.POINTER(ptr), ctypes.POINTER(ptr),
        ctypes.POINTER(ctypes.c_longlong), i32, i32, i32, i32, i32, ptr]
    matmul.gossip_mix_matmul_grouped_launch.restype = i32
    matmul.gossip_mix_matmul_smem_bytes.argtypes = [i32, i32, i32]
    matmul.gossip_mix_matmul_smem_bytes.restype = ctypes.c_longlong
    matmul.gossip_mix_matmul_path.argtypes = [i32, i32]
    matmul.gossip_mix_matmul_path.restype = i32
    matmul.gossip_mix_matmul_error_string.argtypes = [i32]
    matmul.gossip_mix_matmul_error_string.restype = ctypes.c_char_p
    _LIBS.update(zip(names, (gather, matmul)))


def _check_flat(flat: Tensor, what: str, dims: int = 2) -> None:
    if not flat.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {flat.device} "
                         "(CPU tensors go through kernels.gossip_mix.ops)")
    if flat.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: flat must be float32 or bfloat16, "
                        f"got {flat.dtype}")
    if flat.dim() != dims or not flat.is_contiguous():
        raise ValueError(f"{what}: flat must be a contiguous "
                         f"{'[S, K_in, P]' if dims == 3 else '[K_in, P]'} "
                         f"tensor, got shape {tuple(flat.shape)} "
                         f"stride {flat.stride()}")
    if flat.shape[-1] >= 2 ** 31:
        raise ValueError(f"{what}: P = {flat.shape[-1]} does not fit an int32")


def _check_operand(t: Tensor, dtype, shape_hint: str, flat: Tensor,
                   what: str, dims: int = 2) -> None:
    if t.device != flat.device:
        raise ValueError(f"{what}: {shape_hint} is on {t.device}, flat on "
                         f"{flat.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: {shape_hint} must be {dtype}, got {t.dtype}")
    if t.dim() != dims or not t.is_contiguous():
        raise ValueError(f"{what}: {shape_hint} must be contiguous and {dims}-D, "
                         f"got shape {tuple(t.shape)} stride {t.stride()}")


def _raise_on(code: int, name: str, refusal: str | None = None) -> None:
    """Raise on a launcher's non-zero return: ``ValueError(refusal)`` where
    the caller names what the launcher refuses with cudaErrorInvalidValue,
    else ``RuntimeError`` with CUDA's text."""
    if code == _INVALID_VALUE and refusal is not None:
        raise ValueError(f"{name}: launch refused: {refusal}")
    if code != 0:
        text = getattr(_LIBS[name], f"{name}_error_string")(code)
        raise RuntimeError(f"{name}: launch failed with CUDA error {code} "
                           f"({text.decode() if text else '?'})")


def matmul_smem_bytes(k_out: int, k_in: int, dtype: torch.dtype) -> int:
    """Shared memory one block of the grouped matmul kernel takes for a
    ``[K_out, K_in]`` W and leaves in ``dtype`` (builds the kernels on first
    use)."""
    build()
    return _LIBS["gossip_mix_matmul"].gossip_mix_matmul_smem_bytes(
        k_out, k_in, _DTYPE_CODE[dtype])


def matmul_path(k_out: int, k_in: int) -> int:
    """The mapping the grouped matmul kernel's launcher picks for a ``[K_out,
    K_in]`` W: ``MATMUL_TILES`` or ``MATMUL_COLUMNS`` (the one that mixes in
    place when K_out == K_in); builds the kernels on first use."""
    build()
    return _LIBS["gossip_mix_matmul"].gossip_mix_matmul_path(k_out, k_in)


def matmul_max_leaves() -> int:
    """Leaves one launch of the grouped matmul kernel takes (the size of the
    table in its parameters; builds the kernels on first use)."""
    build()
    return _LIBS["gossip_mix_matmul"].gossip_mix_matmul_max_leaves()


def leaf_groups(widths: list[int], max_leaves: int) -> list[list[int]]:
    """The launches of a grouped mix: the positions in ``widths`` of the leaves
    with at least one column, in groups of at most ``max_leaves``."""
    live = [i for i, p in enumerate(widths) if p > 0]
    return [live[i:i + max_leaves] for i in range(0, len(live), max_leaves)]


def gather_max_leaves() -> int:
    """Leaves one launch of the grouped gather kernel takes (the size of the
    table in its parameters; builds the kernels on first use)."""
    build()
    return _LIBS["gossip_mix_gather"].gossip_mix_gather_max_leaves()


def _launch_groups(name: str, flats: list[Tensor], outs: list[Tensor], before: tuple,
                   after: tuple, max_leaves: int, refusal: str | None = None) -> None:
    """``{name}_grouped_launch(*before, x_ptrs, out_ptrs, widths, n, *after,
    stream)`` once per group of ``leaf_groups``, each launch counted; raises
    on a refused launch (``_raise_on``)."""
    launch = getattr(_LIBS[name], f"{name}_grouped_launch")
    with torch.cuda.device(flats[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for ids in leaf_groups([f.shape[-1] for f in flats], max_leaves):
            n = len(ids)
            code = launch(*before,
                          (ctypes.c_void_p * n)(*(flats[i].data_ptr() for i in ids)),
                          (ctypes.c_void_p * n)(*(outs[i].data_ptr() for i in ids)),
                          (ctypes.c_longlong * n)(*(flats[i].shape[-1] for i in ids)),
                          n, *after, stream)
            _raise_on(code, name, refusal)
            launch_counts[name] += 1


def _check_group(flats: list[Tensor], name: str, dims: int = 2) -> None:
    """The leaves of a group: CUDA, contiguous ``[K_in, P_l]`` (``[S, K_in,
    P_l]`` with ``dims=3``), one dtype, one K_in (and S), one device."""
    for flat in flats:
        _check_flat(flat, name, dims)
        if flat.device != flats[0].device:
            raise ValueError(f"{name}: leaves on {flats[0].device} and {flat.device}")
        if flat.dtype != flats[0].dtype:
            raise TypeError(f"{name}: one dtype per group, got {flats[0].dtype} "
                            f"and {flat.dtype}")
        if flat.shape[:-1] != flats[0].shape[:-1]:
            raise ValueError(f"{name}: leaves of {tuple(flats[0].shape[:-1])} "
                             f"and {tuple(flat.shape[:-1])} rows in one group")


def gossip_mix_gather_grouped(idx: Tensor, w: Tensor, flats: list[Tensor]) -> list[Tensor]:
    """Sparse gossip mix of a group of leaves:
    ``out_l[k, p] = sum_d w[k, d] * flats[l][idx[k, d], p]`` for every l.

    idx ``[K_out, D]`` int32 (every id in ``[0, K_in)``, padding slots too —
    not checked here, a check would synchronise), w ``[K_out, D]`` float32 (0
    on padding), each of ``flats`` a contiguous ``[K_in, P_l]`` tensor, all
    float32 or all bfloat16 on ``idx``'s device. f32 accumulation; returns
    ``[K_out, P_l]`` tensors in the leaves' dtype. One launch per
    ``gather_max_leaves()`` leaves that have a column (``leaf_groups``).

    With a seed axis — idx / w ``[S, K_out, D]`` (ids into each seed's own
    ``K_in`` rows), leaves ``[S, K_in, P_l]`` — ``out_l[s, k] = sum_d w[s, k,
    d] * flats[l][s, idx[s, k, d]]`` for every seed in the same launches (the
    kernel folds each row's seed into its ids as it stages them), returning
    ``[S, K_out, P_l]``.
    """
    name = "gossip_mix_gather"
    if not flats:
        return []
    dims = idx.dim()
    if dims not in (2, 3):
        raise ValueError(f"{name}: idx must be [K_out, D] or [S, K_out, D], "
                         f"got {tuple(idx.shape)}")
    _check_group(flats, name, dims)
    _check_operand(idx, torch.int32, "idx", flats[0], name, dims)
    _check_operand(w, torch.float32, "w", flats[0], name, dims)
    if idx.shape != w.shape:
        raise ValueError(f"{name}: idx {tuple(idx.shape)} and w "
                         f"{tuple(w.shape)} differ in shape")
    lead, (k_out, d) = tuple(idx.shape[:-2]), idx.shape[-2:]
    if tuple(flats[0].shape[:-2]) != lead:
        raise ValueError(f"{name}: idx {tuple(idx.shape)} and flat "
                         f"{tuple(flats[0].shape)} carry different seeds")
    k_in = flats[0].shape[-2]
    if d == 0 or (k_in == 0 and k_out > 0):
        raise ValueError(f"{name}: needs at least one slot and one row to "
                         f"gather from (D={d}, K_in={k_in})")
    outs = [torch.empty(lead + (k_out, f.shape[-1]), dtype=f.dtype, device=f.device)
            for f in flats]
    seeds = lead[0] if lead else 1
    if k_out == 0 or seeds == 0:
        return outs
    _launch_groups(name, flats, outs, (idx.data_ptr(), w.data_ptr()),
                   (seeds, k_out, k_in, d, _DTYPE_CODE[flats[0].dtype]),
                   gather_max_leaves())
    return outs


def gossip_mix_gather(idx: Tensor, w: Tensor, flat: Tensor) -> Tensor:
    """Sparse gossip mix of one tensor: ``out[k, p] = sum_d w[k, d] *
    flat[idx[k, d], p]``, the counterpart of the Pallas function — a group of
    one (``gossip_mix_gather_grouped``). idx ``[K_out, D]`` int32, w
    ``[K_out, D]`` float32, flat ``[K_in, P]`` float32 or bfloat16; returns
    ``[K_out, P]`` in ``flat.dtype``."""
    return gossip_mix_gather_grouped(idx, w, [flat])[0]


def gossip_mix_matmul_grouped(mixing: Tensor, flats: list[Tensor],
                              out: list[Tensor] | None = None) -> list[Tensor]:
    """Dense gossip mix of a group of leaves:
    ``out_l[k, p] = sum_j mixing[k, j] * flats[l][j, p]`` for every l.

    mixing ``[K_out, K_in]`` float32 (rectangular allowed, any size), each of
    ``flats`` a contiguous ``[K_in, P_l]`` tensor, all float32 or all
    bfloat16 on ``mixing``'s device. Full-f32 accumulation (no TF32); returns
    ``[K_out, P_l]`` tensors in the leaves' dtype. One launch per
    ``matmul_max_leaves()`` leaves that have a column (``leaf_groups``).

    With a seed axis — ``mixing`` ``[S, K_out, K_in]``, leaves ``[S, K_in,
    P_l]`` — ``out_l[s] = mixing[s] @ flats[l][s]`` for every seed in the same
    launches, returning ``[S, K_out, P_l]``.

    ``out``: the output tensors to write (contiguous, the shapes above, the
    leaves' dtype and device) instead of new ones; ``out=flats`` mixes in
    place, which the column mapping takes when K_out == K_in
    (``matmul_path``). The launcher refuses any other overlap of an output
    with an input or another output among the leaves of one launch, and the
    wrapper raises ``ValueError`` on its refusal.
    """
    name = "gossip_mix_matmul"
    if not flats:
        return [] if out is None else out
    dims = mixing.dim()
    if dims not in (2, 3):
        raise ValueError(f"{name}: mixing must be [K_out, K_in] or "
                         f"[S, K_out, K_in], got {tuple(mixing.shape)}")
    _check_group(flats, name, dims)
    _check_operand(mixing, torch.float32, "mixing", flats[0], name, dims)
    lead, (k_out, k_in) = tuple(mixing.shape[:-2]), mixing.shape[-2:]
    if tuple(flats[0].shape[:-1]) != lead + (k_in,):
        raise ValueError(f"{name}: mixing {tuple(mixing.shape)} does not "
                         f"match flat {tuple(flats[0].shape)}")
    if k_in == 0 and k_out > 0:
        raise ValueError(f"{name}: K_in = 0")
    shapes = [lead + (k_out, f.shape[-1]) for f in flats]
    if out is None:
        outs = [torch.empty(shape, dtype=f.dtype, device=f.device)
                for shape, f in zip(shapes, flats)]
    else:
        outs = list(out)
        if len(outs) != len(flats):
            raise ValueError(f"{name}: {len(outs)} outputs for {len(flats)} leaves")
        for o, f, shape in zip(outs, flats, shapes):
            _check_operand(o, f.dtype, "out", f, name, dims)
            if tuple(o.shape) != shape:
                raise ValueError(f"{name}: out {tuple(o.shape)}, expected {shape}")
    seeds = lead[0] if lead else 1
    if k_out == 0 or seeds == 0:
        return outs
    _launch_groups(name, flats, outs, (mixing.data_ptr(),),
                   (seeds, k_out, k_in, _DTYPE_CODE[flats[0].dtype]),
                   matmul_max_leaves(),
                   None if out is None else (
                       "an output overlaps an input or another output (only out[i] = "
                       "flats[i] itself, with K_out == K_in under the column mapping "
                       "(matmul_path), mixes in place), or a shape the kernel does not take"))
    return outs


def gossip_mix_matmul(mixing: Tensor, flat: Tensor) -> Tensor:
    """Dense gossip mix of one tensor: ``out[k, p] = sum_j mixing[k, j] *
    flat[j, p]``, the counterpart of the Pallas function — a group of one
    (``gossip_mix_matmul_grouped``). mixing ``[K_out, K_in]`` float32, flat
    ``[K_in, P]`` float32 or bfloat16; returns ``[K_out, P]`` in
    ``flat.dtype``."""
    return gossip_mix_matmul_grouped(mixing, [flat])[0]
