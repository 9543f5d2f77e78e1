"""The synchronized DFL simulator (paper Sec. IV/VI).

Wires together: road network + mobility (time-varying contact graphs),
partitioned federated data, per-vehicle local training, and DFL-DDS. The
whole federation state is stacked on a leading vehicle axis.

``run_simulation`` is a thin wrapper over the engine (``repro_torch.fed
.engine``): setup via ``engine.build_context``, then whole epoch windows on
the run's device. The per-epoch loop is kept behind
``SimulationConfig.use_scan_engine = False`` (``run_legacy_loop``): it reads
every epoch's diagnostics back to the host as it goes, and it is the parity
reference the engine is held against, as in the reference package.
"""
from __future__ import annotations

import time

import torch

from ..core import aggregation
from ..core import contacts as contacts_lib
from ..precision import full_f32_matmul
from ..profiling import PhaseTimer
from . import engine as engine_lib
# re-exports: the public simulation API lives here, as in the reference
from .engine import (  # noqa: F401
    EngineContext, SimulationConfig, SimulationResult, make_local_train_fn,
)


def run_simulation(cfg: SimulationConfig, dataset=None, progress: bool = False,
                   timer: PhaseTimer | None = None) -> SimulationResult:
    """One federation, on the engine or the per-epoch loop; ``timer``
    (``profiling.PhaseTimer``) spans its set-up, contact stream and rounds
    on either."""
    ctx = engine_lib.build_context(cfg, dataset=dataset, timer=timer)   # resolves "auto"
    if ctx.cfg.use_scan_engine:
        return engine_lib.run_with_context(ctx, progress=progress)
    with full_f32_matmul():
        return run_legacy_loop(ctx, progress=progress)


def run_legacy_loop(ctx: EngineContext, progress: bool = False) -> SimulationResult:
    """The per-epoch loop: one round per epoch, its diagnostics read back to
    the host before the next epoch starts."""
    cfg = ctx.cfg
    if cfg.overlap != "sync":
        raise ValueError(
            "overlap='delayed' needs the scan engine's double-buffered carry "
            "(set use_scan_engine=True)")
    t0 = time.perf_counter()
    result = SimulationResult(config=cfg, execution_plan=ctx.execution_plan)
    state, rng = ctx.init_state, ctx.init_rng
    payload_mb = engine_lib.exchange_payload_mb(ctx)

    for epoch in range(cfg.epochs):
        # one epoch of the contact stream, in the run's contact format
        # (dense [K, K] matrix or single-epoch SparseContacts)
        contacts = contacts_lib.epoch_of(
            contacts_lib.to_device(ctx.contacts.window(1), ctx.device), 0)
        batch = ctx.sample_fn(ctx.fed_data, rng)
        state, diags = ctx.round_fn(state, contacts, ctx.target, batch, rng,
                                    ctx.fed_data)
        result.kl_trace.append(float(torch.mean(diags["kl_divergence"])))
        result.comm_mb.append(
            float(contacts_lib.count_edges(contacts)) * payload_mb)
        if (epoch + 1) % cfg.eval_every == 0 or epoch == cfg.epochs - 1:
            _record(result, epoch, ctx.model_of(state), diags, ctx.eval_fn,
                    progress, num_vehicles=cfg.num_vehicles)

    ctx.final_state = state
    result.wall_time = time.perf_counter() - t0
    return result


def _record(result, epoch, params_stack, diags, eval_all, progress,
            num_vehicles=None):
    accs = eval_all(params_stack).cpu().numpy()
    if num_vehicles is not None:  # report vehicle metrics only (RSUs excluded)
        accs = accs[:num_vehicles]
    result.epochs_evaluated.append(epoch + 1)
    result.avg_accuracy.append(float(accs.mean()))
    result.vehicle_accuracy.append(accs)
    result.entropy.append(diags["entropy"].cpu().numpy())
    result.kl_divergence.append(diags["kl_divergence"].cpu().numpy())
    result.consensus_distance.append(
        float(aggregation.consensus_distance(params_stack)))
    if progress:
        print(f"  epoch {epoch + 1:4d}  avg_acc={accs.mean():.4f}  "
              f"min={accs.min():.4f}  max={accs.max():.4f}", flush=True)
