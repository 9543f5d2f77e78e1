"""The vehicle axis as a *partitionable* dimension.

Counterpart of ``repro.core.vehicle_axis``. Every federation quantity is
stacked on a leading vehicle axis K: model parameters ``[K, ...]``,
optimizer state, batches. The engine runs that axis in one of two regimes:

* **global** — the whole stack lives on one device (the vmap backend);
* **sharded** — one process per shard (the shard_map backend, over a
  ``torch.distributed`` process group where the reference runs one SPMD
  program over a mesh axis): process r holds the contiguous row block
  ``[r * K/N, (r+1) * K/N)`` of every stack, while the small ``[K, K]``
  state / contact / mixing matrices are replicated on every process.

``VehicleSharding`` captures that choice so the algorithm rounds
(``core.dfl_dds``, ``core.baselines``) are written once and run in both
regimes: a round always *draws* its randomness at global K (picks, dropout
masks — ``local_generator``) and then takes ``local_rows`` — the identity in
the global regime, this shard's row block when sharded — so the random
streams are the same under both backends.

The one cross-vehicle coupling, the gossip contraction ``W @ w`` (Eq. 10),
becomes a sharded product via ``sharded_mix``: each shard multiplies the
*column block* of W it owns rows of ``w`` for against its local rows — a
partial sum over its vehicles — and a reduce-scatter over the group both
completes the sum and deals each shard its own output rows. No shard ever
holds the full ``[K, P]`` model stack.

Also here: the delayed-gossip decomposition of the mix
(``mixing_self_weight``, ``zero_self_weight``, ``delayed_gossip_mix``; every
function takes a leading seed axis in the global regime), the communication
buckets (``comm_buckets``, ``num_comm_buckets``, ``psum_scatter_bytes``) and
the state-layout markers ``ROW`` / ``REPLICATED`` the algorithms' state
specs are written in (``shard_state`` / ``gather_state``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ..profiling import PhaseTimer, phase
from . import contacts as contacts_lib

Tensor = torch.Tensor

MixParamsFn = Callable[[object, dict], dict]

# a state leaf (or subtree) split into row blocks, and one every shard holds
# whole — the port's counterparts of the reference's P("vehicle") and P()
ROW = "row"
REPLICATED = "replicated"


def _collective(new: str, old: str):
    """``torch.distributed.<new>`` where this torch has it, else ``<old>``:
    the same collective under its newer name (same arguments)."""
    return getattr(dist, new, None) or getattr(dist, old)


class RowBlockGenerator(NamedTuple):
    """A ``torch.Generator`` seen from one shard: every draw is made at the
    global row count and this shard keeps its row block, so the shard
    consumes the random stream a global run consumes and gets that run's
    numbers for its rows (``models.cnn`` draws its dropout masks so)."""
    generator: torch.Generator
    rank: int
    num_shards: int

    def rand_rows(self, shape, device) -> Tensor:
        """``torch.rand(shape)`` for this shard's rows: ``shape[0]`` local
        rows of a draw of ``shape[0] * num_shards`` rows, row-major."""
        rows = shape[0]
        full = torch.rand((rows * self.num_shards,) + tuple(shape[1:]),
                          generator=self.generator, device=device)
        return full[self.rank * rows:(self.rank + 1) * rows]


class _Pending(NamedTuple):
    """A collective in flight; ``wait()`` gives its output on ``device``."""
    work: Any
    out: Tensor
    device: torch.device

    def wait(self) -> Tensor:
        if self.work is not None:
            self.work.wait()
        return self.out.to(self.device)


@dataclass(frozen=True)
class VehicleSharding:
    """How the leading vehicle axis is partitioned.

    ``group`` is the ``torch.distributed`` process group the rows are
    sharded over (None = the global single-shard regime), ``rank`` this
    process's position in it and ``num_shards`` its size. Row blocks are
    contiguous and in rank order: shard r owns rows ``[r * K/N, (r+1) *
    K/N)``. ``staged`` sends every collective through host memory (gloo
    over tensors on a card several processes share; ``launch.mesh``).
    """
    group: Any = None
    rank: int = 0
    num_shards: int = 1
    staged: bool = False

    @property
    def is_sharded(self) -> bool:
        return self.group is not None and self.num_shards > 1

    def _start(self, total: int) -> tuple[int, int]:
        k_local = total // self.num_shards
        return self.rank * k_local, k_local

    def local_rows(self, x: Tensor | None) -> Tensor | None:
        """Slice a [K, ...] tensor (built at global K) to this shard's rows."""
        if x is None or not self.is_sharded:
            return x
        start, k_local = self._start(x.shape[0])
        return x[start:start + k_local]

    def local_cols(self, w: Tensor) -> Tensor:
        """Slice a [K, K] matrix to the columns matching this shard's rows."""
        if not self.is_sharded:
            return w
        start, k_local = self._start(w.shape[-1])
        return w[..., start:start + k_local]

    def local_generator(self, generator):
        """The generator the round's local training draws from: itself in
        the global regime, a ``RowBlockGenerator`` when sharded."""
        if generator is None or not self.is_sharded:
            return generator
        return RowBlockGenerator(generator, self.rank, self.num_shards)

    def _wire(self, t: Tensor) -> Tensor:
        return (t.detach().cpu() if self.staged else t).contiguous()

    def psum(self, x: Tensor) -> Tensor:
        """Sum of a per-shard tensor over the group (identity unsharded)."""
        if not self.is_sharded:
            return x
        wire = self._wire(x).clone()
        dist.all_reduce(wire, group=self.group)
        return wire.to(x.device)

    def pmean(self, x: Tensor) -> Tensor:
        """Mean of a per-shard tensor over the group. Shards hold equal row
        counts, so the mean of per-shard means is the global mean."""
        if not self.is_sharded:
            return x
        return self.psum(x) / self.num_shards

    def reduce_scatter_rows(self, t: Tensor, async_op: bool = False) -> _Pending:
        """``[K, ...]`` partial sums of this shard -> the sum over the group
        of its rows ``[r * K/N, (r+1) * K/N)``, as a ``_Pending`` whose
        ``wait()`` gives the ``[K/N, ...]`` block (one
        ``reduce_scatter_tensor``, asynchronous with ``async_op``)."""
        wire = self._wire(t)
        out = torch.empty((wire.shape[0] // self.num_shards,) + tuple(wire.shape[1:]),
                          dtype=wire.dtype, device=wire.device)
        work = _collective("reduce_scatter_single", "reduce_scatter_tensor")(
            out, wire, group=self.group, async_op=async_op)
        return _Pending(work, out, t.device)

    def gather_rows(self, x: Tensor, dim: int = 0) -> Tensor:
        """The inverse of ``local_rows`` along ``dim``: every shard's row
        block, concatenated in rank order (one all-gather)."""
        if not self.is_sharded:
            return x
        wire = self._wire(x.movedim(dim, 0))
        out = torch.empty((wire.shape[0] * self.num_shards,) + tuple(wire.shape[1:]),
                          dtype=wire.dtype, device=wire.device)
        _collective("all_gather_single", "all_gather_into_tensor")(
            out, wire, group=self.group)
        return out.to(x.device).movedim(0, dim)


GLOBAL = VehicleSharding()


def _map_spec(spec, state, row_fn: Callable):
    """Apply ``row_fn`` to every tensor under a ``ROW`` marker of ``spec``
    (a prefix of ``state``'s structure); ``REPLICATED`` subtrees pass."""
    if spec == ROW:
        return pytree.tree_map(row_fn, state)
    if spec == REPLICATED:
        return state
    if isinstance(spec, dict):
        return {name: _map_spec(spec[name], state[name], row_fn) for name in state}
    parts = [_map_spec(s, x, row_fn) for s, x in zip(spec, state)]
    return type(state)(*parts) if hasattr(state, "_fields") else type(state)(parts)


def shard_state(spec, state, shard: VehicleSharding):
    """A global federation state cut to this shard: ``local_rows`` of every
    leaf the spec marks ``ROW``."""
    if not shard.is_sharded:
        return state
    return _map_spec(spec, state, shard.local_rows)


def gather_state(spec, state, shard: VehicleSharding):
    """This shard's state reassembled to the global one on every shard:
    ``gather_rows`` of every leaf the spec marks ``ROW``."""
    if not shard.is_sharded:
        return state
    return _map_spec(spec, state, shard.gather_rows)


def comm_buckets(leaves: list, bucket_bytes: float) -> list[list[int]]:
    """Partition leaves (by index, in order) into contiguous same-dtype
    buckets of at most ``bucket_bytes`` of those leaves each (the sharded
    mix passes a rank's own rows; each bucket's reduce-scatter then carries
    N times that in partial sums). A leaf larger than the budget gets a
    bucket of its own — leaves are never
    split, so the packing is a pure regrouping of the per-leaf collectives
    (BMTrain-style size bucketing)."""
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_bytes, cur_dtype = 0, None
    for i, leaf in enumerate(leaves):
        nbytes = leaf.numel() * leaf.element_size()
        if cur and (leaf.dtype != cur_dtype or cur_bytes + nbytes > bucket_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
        cur_dtype = leaf.dtype
    if cur:
        buckets.append(cur)
    return buckets


def num_comm_buckets(payload_bytes: float, bucket_mb: float, num_leaves: int) -> int:
    """Closed-form bucket count for the cost model: how many reduce-scatters
    one gossip mix issues for ``payload_bytes`` of partial sums. Per-leaf when
    bucketing is off; otherwise the byte-budget packing, which can never
    launch more collectives than there are leaves."""
    if bucket_mb <= 0:
        return max(1, num_leaves)
    return min(max(1, num_leaves),
               max(1, math.ceil(payload_bytes / (bucket_mb * 2**20))))


def local_mixing(mixing, start: int, k_local: int):
    """One shard's part of a replicated mixing: the sources ``[start, start
    + k_local)``. Dense: the ``[K, k_local]`` column block. Sparse: the same
    ``[K, D]`` neighbour list with every id remapped into ``[0, k_local)``
    (``id - start``, clipped) and the weight of every id outside the block
    zeroed, so a gather over the shard's rows sums only the sources it owns."""
    if isinstance(mixing, contacts_lib.SparseMixing):
        loc = mixing.idx - start
        owned = (loc >= 0) & (loc < k_local)
        zero = torch.zeros((), dtype=mixing.w.dtype, device=mixing.w.device)
        return contacts_lib.SparseMixing(
            torch.clamp(loc, 0, k_local - 1).to(mixing.idx.dtype),
            torch.where(owned, mixing.w, zero))
    return mixing[..., start:start + k_local]


def sharded_mix(base_mix_fn: MixParamsFn, shard: VehicleSharding,
                comm_bucket_mb: float = 0.0,
                timer: PhaseTimer | None = None) -> MixParamsFn:
    """Lift a global gossip mix ``(W [K, K], {name: [K, ...]}) -> {name:
    [K, ...]}`` into the sharded regime: a partial product over the local
    vehicles plus a reduce-scatter over the group (``out[k] = sum_j W[k, j]
    x[j]`` with the j-sum spread over the shards and the k-rows dealt back
    out).

    ``base_mix_fn`` must take a rectangular ``[K, K_local]`` block — both
    ``aggregation.mix_params`` and the CUDA kernels of
    ``kernels.gossip_mix.ops.mix_params_cuda`` do. In the global regime the
    base fn is returned untouched.

    A ``contacts.SparseMixing`` shards the same way by *source*: the
    replicated ``[K, D_max]`` neighbour list is remapped onto this shard's
    row block (ids outside the block are clipped into ``[0, K/N)`` and their
    weights zeroed), the base fn's gather gives the ``[K, ...]`` partial sums
    over the sources this shard owns, and the same reduce-scatter completes
    the sum.

    ``comm_bucket_mb > 0`` turns the per-leaf reduce-scatters into a
    pipelined bucketed exchange: leaves are packed into bucket-sized ``[K,
    cols]`` payloads (``comm_buckets``) and bucket i+1's partial product is
    launched while bucket i's reduce-scatter is in flight. The sum over the
    shards is elementwise, so the bucketed path gives the per-leaf path's
    numbers bit for bit; only the count of collectives and their overlap
    change. Each collective (issue and wait) is a ``reduce_scatter`` span
    of ``timer``.
    """
    if not shard.is_sharded:
        return base_mix_fn

    def deal(partial: Tensor) -> Tensor:
        """One leaf's [K, ...] partial sums -> this shard's summed rows."""
        with phase(timer, "reduce_scatter"):
            rows = shard.reduce_scatter_rows(partial.reshape(partial.shape[0], -1)).wait()
        return rows.reshape((rows.shape[0],) + tuple(partial.shape[1:]))

    def mix(mixing, params: dict) -> dict:
        names = list(params)
        leaves = list(params.values())
        k_local = leaves[0].shape[0]
        mixing = local_mixing(mixing, shard.rank * k_local, k_local)
        if comm_bucket_mb <= 0 or len(leaves) <= 1:
            partial = base_mix_fn(mixing, params)     # [K, ...] partial sums
            return {name: deal(partial[name]) for name in names}
        out: dict = {}
        in_flight = None

        def land(pending, shapes):
            with phase(timer, "reduce_scatter"):
                dealt = pending.wait()                 # [K_local, bucket cols]
            widths = [math.prod(s[1:]) for s in shapes.values()]
            for (name, shape), block in zip(shapes.items(), dealt.split(widths, dim=1)):
                out[name] = block.reshape((dealt.shape[0],) + tuple(shape[1:]))

        for idxs in comm_buckets(leaves, comm_bucket_mb * 2**20):
            # partial sums for THIS bucket only, launched while the previous
            # bucket's reduce-scatter is in flight
            partial = base_mix_fn(mixing, {names[i]: leaves[i] for i in idxs})
            k = next(iter(partial.values())).shape[0]
            flat = torch.cat([p.reshape(k, -1) for p in partial.values()], dim=1)
            with phase(timer, "reduce_scatter"):
                pending = shard.reduce_scatter_rows(flat, async_op=True)
            if in_flight is not None:
                land(*in_flight)
            in_flight = (pending, {n: tuple(p.shape) for n, p in partial.items()})
        land(*in_flight)
        return {name: out[name] for name in names}

    return mix


def mixing_self_weight(mixing) -> Tensor:
    """The weight each vehicle keeps on itself — ``W[k, k]`` as a [K] vector
    — for one epoch's mixing in either representation. Sparse padding slots
    carry the row's own id with weight 0, so summing the self-id slots reads
    exactly the real self weight."""
    if isinstance(mixing, contacts_lib.SparseMixing):
        k = mixing.idx.shape[-2]
        rows = torch.arange(k, dtype=mixing.idx.dtype,
                            device=mixing.idx.device)[:, None]
        zero = torch.zeros((), dtype=mixing.w.dtype, device=mixing.w.device)
        return torch.sum(torch.where(mixing.idx == rows, mixing.w, zero), dim=-1)
    return torch.diagonal(mixing, dim1=-2, dim2=-1)


def zero_self_weight(mixing):
    """The same mixing with every self weight removed: the neighbour-only
    part of the gossip contraction (``W - diag(W)``)."""
    if isinstance(mixing, contacts_lib.SparseMixing):
        k = mixing.idx.shape[-2]
        rows = torch.arange(k, dtype=mixing.idx.dtype,
                            device=mixing.idx.device)[:, None]
        zero = torch.zeros((), dtype=mixing.w.dtype, device=mixing.w.device)
        return contacts_lib.SparseMixing(
            mixing.idx, torch.where(mixing.idx == rows, zero, mixing.w))
    eye = torch.eye(mixing.shape[-1], dtype=mixing.dtype, device=mixing.device)
    return mixing * (1.0 - eye)


def delayed_gossip_mix(mix_fn: MixParamsFn,
                       shard: VehicleSharding = GLOBAL) -> Callable:
    """Double-buffered delayed gossip (``SimulationConfig.overlap =
    "delayed"``): the exchange for round t is launched concurrently with
    round t's local training, so neighbours' contributions arrive one round
    stale while each vehicle's own contribution stays current:

        out_k = sum_{j != k} W[k, j] * stale_j  +  W[k, k] * current_k

    ``mix_fn`` is the (possibly shard-wrapped) synchronous mix, applied to
    the neighbour-only mixing ``zero_self_weight(W)`` over the stale buffer
    (the same gossip-mix kernels, on a matrix whose rows sum to less than
    one); the self term multiplies in elementwise, on this shard's rows.
    With no live contacts (W = I) the neighbour term is exactly zero and the
    self weight exactly one, so the degenerate trajectory is bit-identical
    to synchronous gossip."""

    def mix(mixing, params: dict, stale: dict) -> dict:
        neighbours = mix_fn(zero_self_weight(mixing), stale)
        self_w = shard.local_rows(mixing_self_weight(mixing))

        def combine(n: Tensor, c: Tensor) -> Tensor:
            d = self_w.reshape(tuple(self_w.shape) + (1,) * (c.dim() - self_w.dim()))
            return (n.to(torch.float32)
                    + d.to(torch.float32) * c.to(torch.float32)).to(c.dtype)

        return {name: combine(neighbours[name], c) for name, c in params.items()}

    return mix


def psum_scatter_bytes(total_rows: int, row_bytes: int, num_shards: int) -> float:
    """Per-process wire bytes of one reduce-scatter completing the sharded
    gossip contraction: each process ships its ``[K, ...]`` partial sums
    minus the block it keeps — ``(n - 1) / n`` of ``K * row_bytes``. Zero in
    the single-shard regime."""
    if num_shards <= 1:
        return 0.0
    return (num_shards - 1) / num_shards * total_rows * row_bytes


def local_nodes(total_nodes: int, shard: VehicleSharding) -> int:
    """Rows of the vehicle axis this shard owns."""
    if total_nodes % shard.num_shards:
        raise ValueError(
            f"total_nodes={total_nodes} not divisible by "
            f"num_shards={shard.num_shards}")
    return total_nodes // shard.num_shards
