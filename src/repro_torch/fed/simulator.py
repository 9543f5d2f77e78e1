"""The synchronized DFL simulator (paper Sec. IV/VI).

Wires together: road network + mobility (time-varying contact graphs),
partitioned federated data, per-vehicle local training, and DFL-DDS. The
whole federation state is stacked on a leading vehicle axis.

``run_simulation`` is a thin wrapper over the engine (``repro_torch.fed
.engine``): setup via ``engine.build_context``, then whole epoch windows on
the run's device. (The reference's legacy per-epoch loop behind
``use_scan_engine=False`` is not ported; asking for it raises.)
"""
from __future__ import annotations

from . import engine as engine_lib
# re-exports: the public simulation API lives here, as in the reference
from .engine import (  # noqa: F401
    EngineContext, SimulationConfig, SimulationResult, make_local_train_fn,
)


def run_simulation(cfg: SimulationConfig, dataset=None,
                   progress: bool = False) -> SimulationResult:
    ctx = engine_lib.build_context(cfg, dataset=dataset)
    return engine_lib.run_with_context(ctx, progress=progress)
