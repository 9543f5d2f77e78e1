"""Scenario sweep runner: the paper's figure grids in one call.

Counterpart of ``repro.launch.sweep``. Figs. 6-10 compare {DFL-DDS, DFL, SP}
across road networks (grid / random / spider) and data distributions
(balanced non-IID / unbalanced IID). This module maps the engine
(``repro_torch.fed.engine``) over such scenario grids, with the seeds of
each scenario stacked into one run (``engine.run_seeds``), so a whole
reproduction grid is one ``run_sweep`` call.

CLI (installed package; add PYTHONPATH=src from a bare checkout):

  python -m repro_torch.launch.sweep --device cpu      # tiny demo grid
  python -m repro_torch.launch.sweep --algorithms dds dfl sp \
      --road-nets grid random spider --seeds 0 1 2 \
      --vehicles 100 --epochs 300                      # paper scale, on the card

``--device`` defaults to ``cuda`` and raises without a CUDA device.
``--execution auto`` lets the cost model pick the backend, contact format,
mixing backend and slot budget of every scenario (``roofline.scenario_cost``).

Vehicle-sharded runs (``--backend shard_map``) start one process per shard
under ``torchrun``; every rank runs the same sweep and rank 0 prints the
summary. ``--transport`` names how the ranks talk (``launch.mesh``): ``nccl``
(the default, a card per rank), ``gloo`` (CPU ranks) or ``gloo_staged``:

  torchrun --nproc-per-node 2 -m repro_torch.launch.sweep --backend shard_map \
      --transport gloo --device cpu --vehicles 8 --epochs 4
"""
from __future__ import annotations

import argparse
import itertools
import time
from dataclasses import dataclass, field, replace
from typing import Any, Sequence

import numpy as np

from ..data import datasets as data_lib
from ..fed import backends as backends_lib
from ..fed import engine
from ..fed import topology as topology_lib
from ..fed.algorithms import available_algorithms
from ..fed.engine import SimulationConfig, SimulationResult
from . import mesh as mesh_lib


@dataclass
class SweepSpec:
    """A scenario grid: the cross product of road nets x distributions x
    algorithms, each run over ``seeds`` (one seed-stacked engine call per
    cell)."""
    road_nets: Sequence[str] = ("grid",)
    distributions: Sequence[str] = ("balanced_noniid",)
    algorithms: Sequence[str] = ("dds", "dfl", "sp")
    seeds: Sequence[int] = (0,)
    base: SimulationConfig = field(default_factory=SimulationConfig)

    def scenarios(self) -> list[SimulationConfig]:
        return [
            replace(self.base, road_net=net, distribution=dist, algorithm=algo)
            for net, dist, algo in itertools.product(
                self.road_nets, self.distributions, self.algorithms)
        ]


@dataclass
class ScenarioResult:
    config: SimulationConfig               # seed field = base seed
    results: list[SimulationResult]        # one per seed
    # wall time of the whole seed batch (one window loop on the vmap
    # backend) — recorded ONCE here, not replicated into per-seed results
    wall_time: float = 0.0

    @property
    def key(self) -> tuple[str, str, str]:
        return (self.config.road_net, self.config.distribution,
                self.config.algorithm)

    def final_accuracies(self) -> np.ndarray:
        return np.array([r.final_accuracy() for r in self.results])

    def mean_curve(self) -> tuple[list[int], np.ndarray]:
        """(epochs, [num_evals] seed-averaged accuracy curve)."""
        epochs = self.results[0].epochs_evaluated
        return epochs, np.mean([r.avg_accuracy for r in self.results], axis=0)


def run_sweep(spec: SweepSpec, dataset=None, progress: bool = False) -> list[ScenarioResult]:
    """Run every scenario in the grid; one seed-stacked engine call per
    scenario.

    The dataset is loaded once (from ``spec.base``) and shared by every
    scenario and seed — scenario axes only change the topology, partition
    and algorithm.
    """
    ds = dataset or data_lib.load_dataset(spec.base.dataset, seed=spec.base.seed)
    out = []
    for cfg in spec.scenarios():
        if progress and mesh_lib.is_rank_zero():
            print(f"## scenario road_net={cfg.road_net} "
                  f"distribution={cfg.distribution} algorithm={cfg.algorithm} "
                  f"seeds={list(spec.seeds)}", flush=True)
        t0 = time.time()
        results = engine.run_seeds(cfg, spec.seeds, dataset=ds, progress=progress)
        out.append(ScenarioResult(config=cfg, results=results,
                                  wall_time=time.time() - t0))
    return out


def summary_rows(scenario_results: list[ScenarioResult]) -> list[str]:
    """CSV summary: one row per scenario with seed-aggregated accuracy."""
    rows = ["road_net,distribution,algorithm,seeds,final_acc_mean,final_acc_std,wall_s"]
    for sr in scenario_results:
        finals = sr.final_accuracies()
        rows.append(",".join([
            sr.config.road_net, sr.config.distribution, sr.config.algorithm,
            str(len(sr.results)), f"{finals.mean():.4f}", f"{finals.std():.4f}",
            f"{sr.wall_time:.1f}",
        ]))
    return rows


def main(argv: Sequence[str] | None = None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    # choices come from the registries: a newly registered road net or
    # algorithm is sweepable by name with no CLI (or engine) edits
    ap.add_argument("--road-nets", nargs="+", default=["grid"],
                    choices=topology_lib.available_road_networks())
    ap.add_argument("--distributions", nargs="+", default=["balanced_noniid"],
                    choices=["balanced_noniid", "unbalanced_iid"])
    ap.add_argument("--algorithms", nargs="+", default=["dds", "dfl"],
                    choices=available_algorithms())
    ap.add_argument("--seeds", nargs="+", type=int, default=[0])
    ap.add_argument("--dataset", default="mnist", choices=["mnist", "cifar10"])
    ap.add_argument("--vehicles", type=int, default=12)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--p1-steps", type=int, default=60)
    ap.add_argument("--window-size", type=int, default=0,
                    help="epochs per window (0 = whole run in one window)")
    ap.add_argument("--backend", default="vmap",
                    choices=backends_lib.available_backends(),
                    help="execution backend")
    ap.add_argument("--mixing-backend", default="cuda",
                    choices=["cuda", "torch"],
                    help="gossip-mix implementation (cuda = the hand-written "
                         "kernels; their plain versions on a CPU run)")
    ap.add_argument("--device", default="cuda",
                    help="where the runs live: cuda (the default; raises "
                         "without a CUDA device) or cpu")
    ap.add_argument("--execution", default="manual",
                    choices=["manual", "auto"],
                    help="auto picks backend/contact_format/mixing_backend/"
                         "d_max from the analytical cost model "
                         "(roofline.scenario_cost)")
    ap.add_argument("--transport", default="nccl", choices=mesh_lib.TRANSPORTS,
                    help="how the ranks of a torchrun launch talk (shard_map "
                         "backend): nccl (a card per rank), gloo (CPU ranks), "
                         "gloo_staged (ranks sharing a card)")
    args = ap.parse_args(argv)
    mesh_lib.initialize_multihost(transport=args.transport)

    base = SimulationConfig(
        dataset=args.dataset, num_vehicles=args.vehicles, epochs=args.epochs,
        local_steps=args.local_steps, batch_size=args.batch_size,
        eval_every=args.eval_every, p1_steps=args.p1_steps,
        window_size=args.window_size, backend=args.backend,
        mixing_backend=args.mixing_backend, execution=args.execution,
        device=args.device)
    spec = SweepSpec(road_nets=args.road_nets, distributions=args.distributions,
                     algorithms=args.algorithms, seeds=args.seeds, base=base)

    t0 = time.time()
    rows = summary_rows(run_sweep(spec, progress=True))
    if mesh_lib.is_rank_zero():
        print("\n".join(rows), flush=True)
        print(f"# sweep done: {len(spec.scenarios())} scenarios x "
              f"{len(spec.seeds)} seeds in {time.time() - t0:.1f}s", flush=True)
    return rows


if __name__ == "__main__":
    main()
