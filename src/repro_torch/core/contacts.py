"""Contact-graph representations: dense matrices vs padded neighbour lists.

Counterpart of ``repro.core.contacts`` on torch tensors.

* ``SparseContacts(idx, mask)`` — a padded neighbour list (CSR-like with a
  uniform row width): ``idx[..., k, d]`` is the d-th neighbour of vehicle k
  (its **own row id** on padding slots, so gathers are always in-bounds) and
  ``mask`` marks the real contacts. Self is always a real contact
  (``idx == row`` with ``mask == 1`` on exactly one slot per row).
* ``SparseMixing(idx, w)`` — aggregation weights on the same slot layout:
  ``w`` is zero on padding, each row sums to one for row-stochastic mixes.

The one primitive every consumer shares is ``sparse_mix_array``: the gather
+ weighted segment-sum ``out[k] = sum_d w[k, d] * x[idx[k, d]]`` executed as
a loop over the slot axis, so only one ``[K, P]`` gather is live at a time.
``aggregation``, ``state_vector`` and ``kl_solver`` dispatch on these types,
so the algorithm rounds run unchanged under either format.

Host-side windows (``ContactStream``) hold numpy arrays in these tuples; the
engine moves them to the run's device with ``to_device``.

**The seed axis.** ``run_seeds`` stacks S federations on a leading seed axis:
a dense ``[S, K, K]`` matrix, or ``[S, K, D]`` ids that each address their
own seed's K rows. The functions here take either; on neighbour lists the
seed is folded into the row id (``seed_rows``: ``s * K + id`` over the
``[S * K, ...]`` rows), so every seed's rows go through the same per-row
operations as a single run's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor


class SparseContacts(NamedTuple):
    """Padded neighbour lists: ``[..., K, D_max]`` ids + validity mask."""
    idx: Tensor    # int32 neighbour ids; own row id on padding slots
    mask: Tensor   # float32 1 = real contact, 0 = padding


class SparseMixing(NamedTuple):
    """Aggregation weights on a neighbour-list layout (0 on padding)."""
    idx: Tensor    # int32, as in SparseContacts
    w: Tensor      # float32 per-slot weights


def to_device(contacts, device):
    """Move a host contact window (numpy, either format) onto ``device``."""
    if isinstance(contacts, SparseContacts):
        return SparseContacts(torch.as_tensor(contacts.idx, device=device),
                              torch.as_tensor(contacts.mask, device=device))
    return torch.as_tensor(contacts, device=device)


def epoch_of(contacts, t: int, axis: int = 0):
    """Epoch ``t`` of a contact window in either format: ``[T, ...]``, or
    ``[S, T, ...]`` with ``axis=1`` (a seed-stacked window)."""
    if isinstance(contacts, SparseContacts):
        return SparseContacts(contacts.idx.select(axis, t),
                              contacts.mask.select(axis, t))
    return contacts.select(axis, t)


def seed_rows(idx: Tensor) -> Tensor:
    """Fold a seed axis into neighbour ids: ``[S, K, D]`` ids, each into its
    own seed's K rows, -> ``[S * K, D]`` ids into the seed-major
    ``[S * K, ...]`` rows (``s * K + id``)."""
    s, k = idx.shape[0], idx.shape[1]
    offsets = torch.arange(s, dtype=idx.dtype, device=idx.device) * k
    return (idx + offsets.reshape(s, 1, 1)).reshape(s * k, idx.shape[-1])


def seedwise_matmul(a: Tensor, b: Tensor) -> Tensor:
    """``a[s] @ b[s]`` for every seed of ``[S, ...]`` operands, one product
    per seed: each seed gets the very product a single run of it takes (a
    batched product may pick other kernels and round differently, and the
    P1 solve carries such differences from round to round)."""
    return torch.stack([x @ y for x, y in zip(a, b)])


def take_ids(v: Tensor, idx: Tensor) -> Tensor:
    """``out[..., k, d] = v[..., idx[..., k, d]]``: a per-vehicle vector
    ``[K]`` (or ``[S, K]``) read at each slot's neighbour id."""
    if v.dim() == 1:
        return v[idx.long()]
    flat = torch.gather(v, -1, idx.long().flatten(-2))
    return flat.reshape(idx.shape)


def _self_slots(idx: Tensor, valid: Tensor) -> Tensor:
    """0/1 mask of the slot holding each row's own id (real contacts only)."""
    k = idx.shape[-2]
    rows = torch.arange(k, dtype=idx.dtype, device=idx.device).reshape(k, 1)
    return ((idx == rows) & (valid > 0)).to(torch.float32)


def self_slots(contacts: SparseContacts) -> Tensor:
    """[..., K, D] 1 on the slot that is the row's own self-loop."""
    return _self_slots(contacts.idx, contacts.mask)


def count_edges(contacts) -> Tensor:
    """Directed V2V exchanges in one contact graph: contacts minus the
    always-on self loops. Accepts a dense ``[K, K]`` matrix or a single-epoch
    ``SparseContacts`` — the two agree exactly (conversion is lossless)."""
    if isinstance(contacts, SparseContacts):
        if contacts.idx.dim() == 3:   # [S, K, D]: one count per seed
            return (torch.sum(contacts.mask, dim=(-2, -1))
                    - torch.sum(self_slots(contacts), dim=(-2, -1)))
        return torch.sum(contacts.mask) - torch.sum(self_slots(contacts))
    if contacts.dim() == 3:
        return (torch.sum(contacts, dim=(-2, -1))
                - torch.diagonal(contacts, dim1=-2, dim2=-1).sum(-1))
    return torch.sum(contacts) - torch.trace(contacts)


def sparse_mix_array(mixing: SparseMixing, x: Tensor) -> Tensor:
    """``out[k] = sum_d w[k, d] * x[idx[k, d], ...]`` — the sparse gossip mix.

    Looped over the slot axis so peak memory is one gathered ``[K, ...]``
    buffer, not the ``[K, D, ...]`` materialization. f32 accumulation, cast
    back to ``x.dtype`` (mirroring the dense ``aggregation.mix_params``).
    ``idx`` may address fewer rows than it has (rectangular mixes). With a
    seed axis (``idx`` ``[S, K, D]``, ``x`` ``[S, K, ...]``) the seed folds
    into the rows (``seed_rows``).
    """
    if mixing.idx.dim() == 3:
        s, k = mixing.idx.shape[:2]
        out = sparse_mix_array(
            SparseMixing(seed_rows(mixing.idx), mixing.w.reshape(s * k, -1)),
            x.reshape((-1,) + tuple(x.shape[2:])))
        return out.reshape((s, k) + tuple(x.shape[2:]))
    w = mixing.w.to(torch.float32)
    idx = mixing.idx.long()
    acc = torch.zeros(tuple(idx.shape[:-1]) + tuple(x.shape[1:]),
                      dtype=torch.float32, device=x.device)
    trailing = (1,) * (x.dim() - 1)
    for slot in range(idx.shape[-1]):
        gathered = x[idx[:, slot]].to(torch.float32)
        acc = acc + w[:, slot].reshape((-1,) + trailing) * gathered
    return acc.to(x.dtype)


def mix_vector(mixing, y: Tensor) -> Tensor:
    """``W @ y`` for a small ``[K]`` vector (``[S, K]`` with a seed axis)
    under either mixing type."""
    if isinstance(mixing, SparseMixing):
        return torch.sum(mixing.w * take_ids(y, mixing.idx), dim=-1)
    if mixing.dim() == 3:   # each seed's own matrix-vector product
        return torch.stack([m @ v for m, v in zip(mixing, y)])
    return mixing @ y


def mixing_to_dense(mixing: SparseMixing, num_cols: int | None = None) -> np.ndarray:
    """Scatter a SparseMixing back to its dense [K, K'] matrix (host-side;
    for tests and diagnostics — duplicates on padding slots carry w=0)."""
    idx = _numpy(mixing.idx)
    w = _numpy(mixing.w)
    k = idx.shape[0]
    out = np.zeros((k, num_cols or k), np.float32)
    np.add.at(out, (np.arange(k)[:, None], idx), w)
    return out


def pad_slots(contacts: SparseContacts, d_max: int) -> SparseContacts:
    """Widen the slot axis to ``d_max`` (padding = own row id, mask 0);
    host-side, returns numpy arrays."""
    idx, mask = _numpy(contacts.idx), _numpy(contacts.mask)
    extra = d_max - idx.shape[-1]
    if extra < 0:
        raise ValueError(f"cannot shrink slot axis {idx.shape[-1]} -> {d_max}")
    if extra == 0:
        return SparseContacts(idx, mask)
    k = idx.shape[-2]
    rows = np.broadcast_to(np.arange(k, dtype=idx.dtype)[:, None],
                           idx.shape[:-1] + (extra,))
    return SparseContacts(
        np.concatenate([idx, rows], axis=-1),
        np.concatenate([mask, np.zeros_like(mask[..., :1].repeat(extra, -1))],
                       axis=-1))


def stack_windows(windows: list):
    """Stack per-seed contact windows on a leading seed axis for
    ``run_seeds`` (host-side, numpy). Dense windows stack directly; sparse
    windows are first padded to the widest seed's D_max."""
    if isinstance(windows[0], SparseContacts):
        d = max(w.idx.shape[-1] for w in windows)
        padded = [pad_slots(w, d) for w in windows]
        return SparseContacts(np.stack([w.idx for w in padded]),
                              np.stack([w.mask for w in padded]))
    return np.stack([_numpy(w) for w in windows])


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------------
# contact format registry
# --------------------------------------------------------------------------


class ContactFormat:
    """Protocol: how ``ContactStream`` represents a contact window (see
    ``fed.engine``). ``sparse`` formats emit ``SparseContacts`` of width
    D_max; dense formats emit the ``[T, K, K]`` matrix."""

    name: str = "?"
    sparse: bool = False


_CONTACT_FORMATS: dict[str, ContactFormat] = {}


def register_contact_format(cls: type[ContactFormat]) -> type[ContactFormat]:
    """Class decorator: instantiate and register under ``cls.name``."""
    _CONTACT_FORMATS[cls.name] = cls()
    return cls


def get_contact_format(name: str) -> ContactFormat:
    try:
        return _CONTACT_FORMATS[name]
    except KeyError:
        raise ValueError(
            f"unknown contact format {name!r} "
            f"(registered: {'|'.join(available_contact_formats())})") from None


def available_contact_formats() -> list[str]:
    return sorted(_CONTACT_FORMATS)


def contact_format_registry() -> dict[str, ContactFormat]:
    """Snapshot of the registry (name -> format), for the docs tables."""
    return dict(_CONTACT_FORMATS)


@register_contact_format
class DenseContactFormat(ContactFormat):
    """Dense [T, K, K] 0/1 contact matrices; O(K^2) memory/compute — exact at any density, the small-fleet fallback."""

    name = "dense"
    sparse = False


@register_contact_format
class SparseContactFormat(ContactFormat):
    """Padded neighbour lists [T, K, D_max] (ids + weights); O(K * D_max) memory/compute — the fleet-scale default."""

    name = "sparse"
    sparse = True
