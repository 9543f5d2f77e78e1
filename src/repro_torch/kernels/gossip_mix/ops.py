"""Public wrapper: apply the gossip mix to a dictionary of stacked parameters
through the hand-written CUDA kernels (``mixing_backend="cuda"``).

Counterpart of ``repro.kernels.gossip_mix.ops.mix_params_pallas``. Both
mixing representations route through here: a dense ``[K_out, K_in]`` matrix
hits the grouped product kernel, a ``core.contacts.SparseMixing`` neighbour
list the grouped gather kernel; either way one launch for all the leaves of
one dtype (one launch per mix for a model of one dtype), and for every seed
of a seed-stacked run (``run_seeds``).

``mix_params_cuda_`` is its in-place twin for a square dense W: it writes
the mix into the leaves themselves (the transformer train round's default,
which then holds no second copy of the stack).

A leaf that lies on the CPU goes to the plain versions in ``ref`` — for that
reason only. A CUDA leaf launches the kernel or raises; nothing falls back.
"""
from __future__ import annotations

from functools import partial

import torch

from ...core.contacts import SparseMixing
from . import kernel, ref

Tensor = torch.Tensor


def mix_params_cuda(mixing, params: dict) -> dict:
    """Drop-in replacement for ``repro_torch.core.aggregation.mix_params``.

    Flattens every leaf to ``[K_in, -1]``, runs the kernel, reshapes to
    ``(K_out,) + leaf.shape[1:]``. ``mixing`` may be rectangular
    ``[K_out, K_in]`` or a ``SparseMixing`` whose ids address the leaf rows.
    With a seed axis (``[S, K_out, K_in]`` or ``[S, K_out, D]`` ids over
    ``[S, K_in, ...]`` leaves) every seed goes through the same one launch.
    """
    sparse = isinstance(mixing, SparseMixing)
    lead = (mixing.idx if sparse else mixing).dim() - 1   # 2 with a seed axis
    flats = {name: x.reshape(tuple(x.shape[:lead]) + (-1,)).contiguous()
             for name, x in params.items()}
    if sparse:
        idx = mixing.idx.to(torch.int32).contiguous()
        w = mixing.w.to(torch.float32).contiguous()
        plain = partial(ref.gossip_mix_gather_ref, idx, w)
        grouped = partial(kernel.gossip_mix_gather_grouped, idx, w)
        out_rows = tuple(idx.shape[:-1])
    else:
        dense = mixing.to(torch.float32).contiguous()
        plain = partial(ref.gossip_mix_matmul_ref, dense)
        grouped = partial(kernel.gossip_mix_matmul_grouped, dense)
        out_rows = tuple(dense.shape[:-1])
    mixed = {name: plain(flat) for name, flat in flats.items() if not flat.is_cuda}
    on_card = [name for name, flat in flats.items() if flat.is_cuda]
    for dtype in dict.fromkeys(flats[name].dtype for name in on_card):
        group = [name for name in on_card if flats[name].dtype == dtype]
        mixed.update(zip(group, grouped([flats[n] for n in group])))
    return {name: mixed[name].reshape(out_rows + tuple(x.shape[lead:]))
            for name, x in params.items()}


def mix_params_cuda_(mixing: Tensor, params: dict) -> dict:
    """``mix_params_cuda`` written into the leaves: every leaf of ``params``
    becomes ``mixing @ leaf`` (over its leading vehicle axis, after any seed
    axis), and ``params`` — the same dictionary, the same tensors — is
    returned.

    ``mixing`` a dense square ``[K, K]`` (or ``[S, K, K]``) W. CUDA leaves,
    each contiguous, go through ``gossip_mix_matmul`` with ``out=`` the leaves
    (one launch per dtype for the whole dictionary); the wrapper raises where
    the kernel's launcher would not mix in place (``kernel.matmul_path``). A
    CPU leaf is overwritten with the plain product (``ref``). A
    ``SparseMixing`` or a rectangular W raises: nothing is allocated in place
    of the mix.
    """
    name = "mix_params_cuda_"
    if isinstance(mixing, SparseMixing):
        raise TypeError(f"{name}: the in-place mix takes a dense W; a SparseMixing "
                        "goes through mix_params_cuda")
    dense = mixing.to(torch.float32).contiguous()
    if dense.dim() not in (2, 3) or dense.shape[-1] != dense.shape[-2]:
        raise ValueError(f"{name}: the in-place mix takes a square [K, K] or "
                         f"[S, K, K] W, got {tuple(dense.shape)}")
    lead = dense.dim() - 1                                 # 2 with a seed axis
    on_card = {}
    for key, leaf in params.items():
        flat_shape = tuple(leaf.shape[:lead]) + (-1,)
        if not leaf.is_cuda:
            leaf.copy_(ref.gossip_mix_matmul_ref(dense, leaf.reshape(flat_shape))
                       .reshape(leaf.shape))
        elif not leaf.is_contiguous():
            raise ValueError(f"{name}: leaf {key!r} is not contiguous (stride "
                             f"{leaf.stride()}): its flat view would be a copy")
        else:
            on_card[key] = leaf.view(flat_shape)
    for dtype in dict.fromkeys(flat.dtype for flat in on_card.values()):
        group = [flat for flat in on_card.values() if flat.dtype == dtype]
        kernel.gossip_mix_matmul_grouped(dense, group, out=group)
    return params
