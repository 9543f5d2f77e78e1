"""Execution backends for the engine, behind a string-keyed registry.

A backend decides *where the stacked vehicle axis lives* while a window runs;
the algorithm rounds (fed.algorithms -> core rounds) are backend-agnostic.

* ``vmap`` — the whole federation stacked on one device (the name is the
  reference's, where the stack is a ``jax.vmap``; here the vehicle axis is a
  leading batch dimension written out).

  ``run_seeds`` stacks S federations on a leading seed axis and runs them
  through one window loop (``engine.stack_contexts``).

The reference's ``shard_map`` backend (vehicle axis sharded over a device
mesh) is still to port. Select with ``SimulationConfig.backend``; register
new backends with ``register_backend``.
"""
from __future__ import annotations

import time
from dataclasses import replace

from ..core import contacts as contacts_lib
from ..data import datasets as data_lib
from . import engine as engine_lib


class Backend:
    """Protocol: drive one federation (or a batch of seeds) through the
    window loop."""

    name: str = "?"

    def run(self, ctx: "engine_lib.EngineContext", progress: bool = False):
        raise NotImplementedError

    def run_seeds(self, cfg, seeds, dataset=None, progress: bool = False):
        raise NotImplementedError


_BACKENDS: dict[str, Backend] = {}

# registered in the reference, still to port here (see ROADMAP.md)
NOT_YET_PORTED = ("shard_map",)


def register_backend(cls: type[Backend]) -> type[Backend]:
    _BACKENDS[cls.name] = cls()
    return cls


def get_backend(name: str) -> Backend:
    if name in NOT_YET_PORTED and name not in _BACKENDS:
        raise NotImplementedError(
            f"repro_torch: backend {name!r} arrives with the "
            "sharded-execution slice")
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


def _drive_windows(ctx, window_fn, progress: bool):
    """The window-driving loop: advance the contact stream, move each window
    to the run's device, run it through ``window_fn`` and collect the masked
    trajectory rows."""
    cfg = ctx.cfg
    t0 = time.time()
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
                                  progress)
    ctx.final_state = state
    result.wall_time = time.time() - t0
    return result


@register_backend
class VmapBackend(Backend):
    """Single-device engine: the whole federation stacked on one device."""

    name = "vmap"

    def run(self, ctx, progress: bool = False):
        return _drive_windows(ctx, ctx.window_fn, progress)

    def run_seeds(self, cfg, seeds, dataset=None, progress: bool = False):
        """S independent federations (seeded partitions, mobility traces and
        inits) through ONE window loop over the seed-stacked state. Per-seed
        index tables are padded to a common width and sparse windows to a
        common D_max so they stack."""
        ds = dataset or data_lib.load_dataset(cfg.dataset, seed=cfg.seed)
        ctxs = [engine_lib.build_context(replace(cfg, seed=int(s)), dataset=ds)
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
