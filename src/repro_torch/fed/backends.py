"""Execution backends for the engine, behind a string-keyed registry.

A backend decides *where the stacked vehicle axis lives* while a window runs;
the algorithm rounds (fed.algorithms -> core rounds) are backend-agnostic.

* ``vmap`` — the whole federation stacked on one device (the name is the
  reference's, where the stack is a ``jax.vmap``; here the vehicle axis is a
  leading batch dimension written out).

  ``run_seeds`` stacks S federations on a leading seed axis and runs them
  through one window loop (``engine.stack_contexts``).
* ``shard_map`` — the vehicle axis split over the processes of a
  ``torch.distributed`` group (the name is the reference's, where one SPMD
  program runs over a device mesh's ``vehicle`` axis; here each process is
  one shard, ``launch.mesh``): params / optimizer state / batches are row
  blocks per process, the tiny [K, K] state / contact / mixing matrices are
  replicated, and the gossip contraction ``W @ w`` runs as a per-shard
  partial product (through the gossip-mix kernels under
  ``mixing_backend="cuda"``) plus a reduce-scatter
  (``core.vehicle_axis.sharded_mix``). Every process returns the same global
  ``SimulationResult``.

Select with ``SimulationConfig.backend``; register new backends with
``register_backend``.
"""
from __future__ import annotations

import time
from dataclasses import replace

import torch.distributed as dist

from ..core import contacts as contacts_lib
from ..core import vehicle_axis
from ..data import datasets as data_lib
from ..launch import mesh as mesh_lib
from . import engine as engine_lib


class Backend:
    """Protocol: drive one federation (or a batch of seeds) through the
    window loop."""

    name: str = "?"

    def run(self, ctx: "engine_lib.EngineContext", progress: bool = False):
        raise NotImplementedError

    def run_seeds(self, cfg, seeds, dataset=None, progress: bool = False, timer=None):
        raise NotImplementedError


_BACKENDS: dict[str, Backend] = {}


def register_backend(cls: type[Backend]) -> type[Backend]:
    _BACKENDS[cls.name] = cls()
    return cls


def get_backend(name: str) -> Backend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown execution backend {name!r} "
            f"(registered: {'|'.join(available_backends())})") from None


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


def backend_registry() -> dict[str, Backend]:
    """Snapshot of the registry (name -> instance), for the docs tables."""
    return dict(_BACKENDS)


def _drive_windows(ctx, window_fn, progress: bool, echo: bool = True):
    """The window-driving loop: advance the contact stream, move each window
    to the run's device, run it through ``window_fn`` and collect the masked
    trajectory rows. ``progress`` aligns the windows to the eval cadence
    (the same on every rank of a sharded run); the progress lines are printed
    where ``echo`` is also true."""
    cfg = ctx.cfg
    t0 = time.perf_counter()
    result = engine_lib.SimulationResult(config=cfg,
                                         execution_plan=ctx.execution_plan)
    window_size = engine_lib._default_window(cfg, progress)
    state, rng = ctx.init_state, ctx.init_rng
    for start in range(0, cfg.epochs, window_size):
        length = min(window_size, cfg.epochs - start)
        contacts = contacts_lib.to_device(ctx.contacts.window(length),
                                          ctx.device)
        mask = engine_lib._eval_mask(cfg, start, length)
        state, rng, traj = window_fn(
            state, rng, ctx.fed_data, ctx.target, contacts, mask)
        engine_lib._append_window(result, traj, mask, start, cfg.num_vehicles,
                                  progress and echo)
    ctx.final_state = state
    result.wall_time = time.perf_counter() - t0
    return result


@register_backend
class VmapBackend(Backend):
    """Single-device engine: the whole federation stacked on one device."""

    name = "vmap"

    def run(self, ctx, progress: bool = False):
        return _drive_windows(ctx, ctx.window_fn, progress)

    def run_seeds(self, cfg, seeds, dataset=None, progress: bool = False, timer=None):
        """S independent federations (seeded partitions, mobility traces and
        inits) through ONE window loop over the seed-stacked state. Per-seed
        index tables are padded to a common width and sparse windows to a
        common D_max so they stack. The stacked rounds keep the first seed's
        setup, and with it ``timer``."""
        ds = dataset or data_lib.load_dataset(cfg.dataset, seed=cfg.seed)
        ctxs = [engine_lib.build_context(replace(cfg, seed=int(s)), dataset=ds, timer=timer)
                for s in seeds]
        batch = engine_lib.stack_contexts(ctxs, ds)
        window_fn = batch.window_fn
        results = [engine_lib.SimulationResult(config=c.cfg) for c in ctxs]
        window_size = engine_lib._default_window(cfg, progress)
        state, rngs = batch.init_state, batch.init_rng
        for start in range(0, cfg.epochs, window_size):
            length = min(window_size, cfg.epochs - start)
            # per-seed windows stack on a leading seed axis: [S, T, ...]
            contacts = contacts_lib.to_device(contacts_lib.stack_windows(
                [c.contacts.window(length) for c in ctxs]), batch.device)
            mask = engine_lib._eval_mask(cfg, start, length)
            state, rngs, traj = window_fn(state, rngs, batch.fed_data,
                                          batch.target, contacts, mask)
            for s, result in enumerate(results):
                engine_lib._append_window(
                    result, {name: v[:, s] for name, v in traj.items()}, mask,
                    start, cfg.num_vehicles, progress)
        return results


def vehicle_shards(total_nodes: int, max_shards: int | None = None) -> int:
    """Largest rank count that divides the vehicle axis evenly — the shard
    count the shard_map backend uses (public: tests and benchmarks report
    it). The ranks of the default process group take the place of the
    reference's ``jax.device_count()``."""
    ranks = mesh_lib.world_size()
    limit = min(max_shards or ranks, ranks, total_nodes)
    return max(d for d in range(1, limit + 1) if total_nodes % d == 0)


@register_backend
class ShardMapBackend(Backend):
    """Vehicle-sharded engine over the federation mesh's ``vehicle`` group.

    Every rank of the default process group (``launch.mesh
    .initialize_multihost``) runs this backend on the same config; rank r
    holds rows ``[r * K/N, (r+1) * K/N)`` of every stack
    (``EngineContext.bind``) and the window loop runs on them, so each rank's
    gossip mix is one partial product and one reduce-scatter per bucket. The
    per-vehicle accuracy rows are all-gathered and the final state
    reassembled, so every rank returns the global result; only rank 0 prints
    progress.

    With no process group, or a group of one, it runs the global path (as the
    reference does on one device). Where the vehicle count does not divide
    over every rank (``vehicle_shards`` < world size) it raises and names the
    rank count to launch: a process cannot sit a collective out.
    """

    name = "shard_map"

    def shard_for(self, cfg, total_nodes: int) -> vehicle_axis.VehicleSharding:
        """This process's ``VehicleSharding`` for a run of ``total_nodes``
        rows (``GLOBAL`` with no group, or a group of one)."""
        ranks = mesh_lib.world_size()
        if ranks <= 1:
            return vehicle_axis.GLOBAL
        n = vehicle_shards(total_nodes)
        if n < ranks:
            raise ValueError(
                f"shard_map: {total_nodes} vehicles do not divide over {ranks} ranks; "
                f"launch {n} rank(s) (the largest count that divides them)")
        transport = mesh_lib.transport()
        if transport is None:
            raise RuntimeError("shard_map: bring the process group up with "
                               "launch.mesh.initialize_multihost(transport=...)")
        mesh_lib.check_transport(transport, cfg.device)
        group = mesh_lib.make_multihost_federation_mesh(vehicle=n).get_group("vehicle")
        return vehicle_axis.VehicleSharding(
            group=group, rank=dist.get_rank(group), num_shards=n,
            staged=transport == "gloo_staged")

    def run(self, ctx, progress: bool = False):
        shard = self.shard_for(ctx.cfg, ctx.total_nodes)
        if not shard.is_sharded:
            return _drive_windows(ctx, ctx.window_fn, progress)
        bound = ctx.bind(shard)
        result = _drive_windows(bound, bound.window_fn, progress, echo=shard.rank == 0)
        ctx.final_state = vehicle_axis.gather_state(ctx.state_spec(), bound.final_state,
                                                    shard)
        return result

    def run_seeds(self, cfg, seeds, dataset=None, progress: bool = False, timer=None):
        """Seeds run one after another, each vehicle-sharded over the whole
        group — the ranks go to the vehicle axis, not to a seed axis. Each
        result equals the vmap backend's run of that seed."""
        ds = dataset or data_lib.load_dataset(cfg.dataset, seed=cfg.seed)
        return [self.run(engine_lib.build_context(replace(cfg, seed=int(s)), dataset=ds,
                                                  timer=timer),
                         progress=progress)
                for s in seeds]
