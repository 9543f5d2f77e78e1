"""Campaign runner: declarative paper-figure reproduction on the engine.

Counterpart of ``repro.launch.campaign``. A *figure* is a set of scenarios
(dataset, road_net, distribution, algorithm) plus two pure functions over
their results: ``derive`` (the figure's table rows) and ``check`` (its
pass/fail ordering assertions — the reproduction claims, e.g. dds >= dfl >=
sp final accuracy). A *campaign* is a set of figures run over shared seeds
at one scale tier.

``run_campaign`` lowers the whole thing onto the seed-stacked engine: every
scenario is one ``launch.sweep.run_sweep`` cell, which runs all of its seeds
in one window loop (``fed.engine.run_seeds``) on whichever execution backend
and device the base config names. No scenario goes through the per-epoch
loop.

Scenario runs are deduplicated twice:

* across figures — Fig. 3 shares Fig. 2's SP runs, Figs. 9/10 share
  Fig. 8's grid runs — via the content hash of (semantic config, seeds,
  dataset signature);
* across invocations — the same hash keys the JSONL results store
  (``launch.results_store``), so re-running a campaign recomputes nothing
  and ``--force`` is an explicit choice.

The content hash is the reference's, field for field: a scenario of the
port hashes to the reference's ``spec_hash`` for the same semantic config,
seeds and dataset, because the port's one extra field, ``device``, is
non-semantic like the other execution knobs. The port's store is its own
file all the same (``results/campaign_smoke_torch.jsonl`` by default): its
trajectories come from other random streams.

Figures register by name (``register_figure``) exactly like algorithms,
road nets, mobility models, and backends; ``repro_torch/figures/fig*.py``
are the registered paper figures, and ``python -m repro_torch.figures.run
--campaign smoke`` is the CLI.
"""
from __future__ import annotations

import datetime
import hashlib
import json
from dataclasses import dataclass, field, fields, replace
from typing import Any, Callable, Sequence

import numpy as np

from ..data import datasets as data_lib
from ..fed import metrics
from ..fed.engine import SimulationConfig
from . import mesh as mesh_lib
from . import report as report_lib
from . import sweep as sweep_lib
from .results_store import ResultsStore, jsonable

# (dataset, road_net, distribution, algorithm) — the scenario axes a figure
# varies; everything else comes from the campaign's base config (scale tier)
Key = tuple[str, str, str, str]

# config fields that do NOT change trajectories beyond float summation
# order (parity-tested to ~1e-5/step across execution paths and contact
# formats; long chaotic training runs can drift further, which is why checks
# carry tolerances) — excluded from the content hash, recorded in the row's
# `engine` section instead
NON_SEMANTIC_FIELDS = frozenset({
    # where the run lives: the port's one field the reference lacks (the
    # hash stays the reference's)
    "device",
    "use_scan_engine", "window_size", "backend", "mixing_backend",
    "contact_format", "d_max", "contact_density",
    # "auto" only chooses among the knobs above, so it is hash-neutral by
    # construction
    "execution",
    # the bucketed-collective payload size only regroups the sharded mix's
    # psum_scatters (elementwise sums — parity-tested identical)
    "comm_bucket_mb",
})

# semantic fields added AFTER store rows were first committed enter the hash
# only when off-default: a run at the elided default is byte-identical to a
# pre-knob run, so historic rows keep their hashes and stay cache hits.
# ("overlap" came with the delayed-gossip mode.)
HASH_ELIDED_DEFAULTS = {"overlap": "sync"}


@dataclass(frozen=True)
class Check:
    """One pass/fail reproduction assertion (rendered in the report)."""
    name: str
    passed: bool
    detail: str = ""


@dataclass(frozen=True)
class FigureSpec:
    """A paper figure as a declarative scenario grid + derived metrics.

    ``derive(spec, rows)`` returns the figure's table (list of dicts, one
    per table row); ``check(spec, rows)`` returns its ``Check`` list.
    ``rows`` maps each scenario ``Key`` to its results-store row. A figure
    either spans the cross product of the grid fields or names explicit
    ``cases`` (e.g. Fig. 10 pairs mnist/balanced with cifar10/unbalanced).
    """
    name: str
    title: str
    dataset: str = "mnist"
    road_nets: tuple[str, ...] = ("grid",)
    distributions: tuple[str, ...] = ("balanced_noniid",)
    algorithms: tuple[str, ...] = ("dds", "dfl", "sp")
    cases: tuple[Key, ...] | None = None
    derive: Callable[["FigureSpec", dict[Key, dict]], list[dict]] | None = None
    check: Callable[["FigureSpec", dict[Key, dict]], list[Check]] | None = None

    def scenario_keys(self) -> list[Key]:
        if self.cases is not None:
            return [tuple(c) for c in self.cases]
        return [(self.dataset, net, dist, algo)
                for net in self.road_nets
                for dist in self.distributions
                for algo in self.algorithms]


_FIGURES: dict[str, FigureSpec] = {}


def register_figure(spec: FigureSpec) -> FigureSpec:
    _FIGURES[spec.name] = spec
    return spec


def get_figure(name: str) -> FigureSpec:
    try:
        return _FIGURES[name]
    except KeyError:
        raise ValueError(
            f"unknown figure {name!r} "
            f"(registered: {'|'.join(available_figures())})") from None


def available_figures() -> list[str]:
    return sorted(_FIGURES)


def figure_registry() -> dict[str, FigureSpec]:
    """Snapshot of the registry (name -> spec), for the docs tables."""
    return dict(_FIGURES)


@dataclass
class CampaignSpec:
    """A figure set run over shared seeds at one scale tier (``base``)."""
    name: str = "smoke"
    figures: tuple[str, ...] = ()
    seeds: tuple[int, ...] = (0, 1, 2)
    base: SimulationConfig = field(default_factory=SimulationConfig)
    # dataset name -> loaded dataset; defaults to data.datasets.load_dataset
    dataset_factory: Callable[[str], Any] | None = None
    store_path: str = "results/campaign_smoke_torch.jsonl"
    results_md: str | None = None


@dataclass
class FigureResult:
    spec: FigureSpec
    table: list[dict]
    checks: list[Check]
    scenario_rows: list[dict]

    @property
    def passed(self) -> bool:
        return all(c.passed for c in self.checks)


def scenario_config(base: SimulationConfig, key: Key) -> SimulationConfig:
    """Lower a scenario key onto the campaign's base config. The algorithm
    axis may carry an ``@<overlap>`` variant suffix (e.g. ``"dds@delayed"``):
    the same registered algorithm with the engine's gossip-overlap mode set
    to the suffix — how a figure puts synchronous and delayed-gossip runs of
    one algorithm side by side on the grid."""
    dataset, net, dist, algo = key
    algo, _, variant = algo.partition("@")
    cfg = replace(base, dataset=dataset, road_net=net, distribution=dist,
                  algorithm=algo)
    return replace(cfg, overlap=variant) if variant else cfg


def dataset_signature(ds) -> list:
    """What makes two loaded datasets interchangeable for caching: name +
    split sizes (synthetic stand-ins vs real files differ in size)."""
    return [ds.name, int(len(ds.train_y)), int(len(ds.test_y))]


def spec_hash(cfg: SimulationConfig, seeds: Sequence[int], ds_sig: list) -> str:
    """Content hash of everything that determines the trajectories; the
    excluded execution knobs are parity-tested trajectory-neutral, and
    late-added semantic knobs at their ``HASH_ELIDED_DEFAULTS`` value are
    dropped so pre-knob rows keep hashing identically."""
    semantic = {}
    for f in fields(cfg):
        if f.name in NON_SEMANTIC_FIELDS:
            continue
        v = getattr(cfg, f.name)
        if f.name in HASH_ELIDED_DEFAULTS and v == HASH_ELIDED_DEFAULTS[f.name]:
            continue
        semantic[f.name] = v
    payload = {"config": semantic, "seeds": [int(s) for s in seeds],
               "dataset": ds_sig}
    blob = json.dumps(jsonable(payload), sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def scenario_row(key: Key, cfg: SimulationConfig, seeds: Sequence[int],
                 sr: "sweep_lib.ScenarioResult", ds_sig: list,
                 h: str) -> dict:
    """Flatten one ScenarioResult (S seed trajectories) into a store row."""
    acc_mean, acc_std = metrics.mean_std(sr.final_accuracies())
    semantic = {f.name: getattr(cfg, f.name) for f in fields(cfg)
                if f.name not in NON_SEMANTIC_FIELDS}
    # the knobs that actually ran (the results carry the config each seed
    # ran with)
    rcfg = sr.results[0].config
    return jsonable({
        "spec_hash": h,
        "key": list(key),
        "config": semantic,
        "engine": {"backend": rcfg.backend,
                   "mixing_backend": rcfg.mixing_backend,
                   "contact_format": rcfg.contact_format,
                   "device": rcfg.device,
                   "execution": cfg.execution,
                   "execution_plan": sr.results[0].execution_plan,
                   "path": "run_sweep/run_seeds"},
        "dataset_sig": ds_sig,
        "seeds": [int(s) for s in seeds],
        "epochs_evaluated": sr.results[0].epochs_evaluated,
        "final_accuracy": [r.final_accuracy() for r in sr.results],
        "final_accuracy_mean": float(acc_mean),
        "final_accuracy_std": float(acc_std),
        "avg_accuracy": [r.avg_accuracy for r in sr.results],
        "consensus_distance": [r.consensus_distance for r in sr.results],
        "vehicle_accuracy": [[a for a in r.vehicle_accuracy] for r in sr.results],
        "entropy": [[e for e in r.entropy] for r in sr.results],
        "kl_trace": [r.kl_trace for r in sr.results],
        "comm_mb": [r.comm_mb for r in sr.results],
        "wall_time_s": round(sr.wall_time, 3),
        "created_at": datetime.datetime.now(datetime.timezone.utc)
                      .isoformat(timespec="seconds"),
    })


def run_campaign(spec: CampaignSpec, force: bool = False,
                 progress: bool = False) -> list[FigureResult]:
    """Run every figure's scenarios (store-cached, cross-figure-deduped)
    through ``run_sweep`` and derive the figure tables + checks. Writes
    ``spec.results_md`` (the markdown report) when set."""
    figure_specs = [get_figure(n) for n in spec.figures]
    store = ResultsStore(spec.store_path)
    cached = {} if force else dict(store.load())

    datasets: dict[str, Any] = {}

    def ds_for(name: str):
        if name not in datasets:
            factory = spec.dataset_factory or (
                lambda n: data_lib.load_dataset(n, seed=spec.base.seed))
            datasets[name] = factory(name)
        return datasets[name]

    # ordered unique scenario keys across the whole figure set
    all_keys: list[Key] = []
    for fig in figure_specs:
        for key in fig.scenario_keys():
            if key not in all_keys:
                all_keys.append(key)

    key_rows: dict[Key, dict] = {}
    for key in all_keys:
        ds = ds_for(key[0])
        cfg = scenario_config(spec.base, key)
        h = spec_hash(cfg, spec.seeds, dataset_signature(ds))
        row = cached.get(h)
        if row is None:
            if progress:
                print(f"## campaign {spec.name}: running {'/'.join(key)} "
                      f"seeds={list(spec.seeds)}", flush=True)
            # the sweep axis gets the RESOLVED algorithm name — any @variant
            # suffix has already landed on cfg.overlap in scenario_config
            cell = sweep_lib.SweepSpec(
                road_nets=(key[1],), distributions=(key[2],),
                algorithms=(cfg.algorithm,), seeds=spec.seeds, base=cfg)
            sr = sweep_lib.run_sweep(cell, dataset=ds, progress=progress)[0]
            row = scenario_row(key, cfg, spec.seeds, sr,
                               dataset_signature(ds), h)
            if mesh_lib.is_rank_zero():      # one writer under torchrun
                store.append(row)
            cached[h] = row
        elif progress:
            print(f"## campaign {spec.name}: cached  {'/'.join(key)} "
                  f"[{h}]", flush=True)
        key_rows[key] = row

    results = []
    for fig in figure_specs:
        rows = {key: key_rows[key] for key in fig.scenario_keys()}
        table = fig.derive(fig, rows) if fig.derive else default_table(rows)
        checks = fig.check(fig, rows) if fig.check else []
        results.append(FigureResult(
            spec=fig, table=table, checks=checks,
            scenario_rows=[rows[k] for k in fig.scenario_keys()]))

    if spec.results_md and mesh_lib.is_rank_zero():
        report_lib.write_results(spec, results, spec.results_md)
    return results


# --------------------------------------------------------------------------
# row accessors — the small vocabulary figure derive/check functions use
# --------------------------------------------------------------------------

def default_table(rows: dict[Key, dict]) -> list[dict]:
    return [{
        "dataset": k[0], "road_net": k[1], "distribution": k[2],
        "algorithm": k[3], "final_acc_mean": r["final_accuracy_mean"],
        "final_acc_std": r["final_accuracy_std"],
    } for k, r in rows.items()]


def seed_mean_curve(row: dict) -> tuple[list[int], np.ndarray]:
    """(eval epochs, seed-averaged avg-accuracy curve)."""
    return row["epochs_evaluated"], np.mean(row["avg_accuracy"], axis=0)


def final_vehicle_accuracies(row: dict) -> np.ndarray:
    """Per-vehicle final accuracies pooled over seeds: [S * K]."""
    return np.concatenate([np.asarray(v[-1]) for v in row["vehicle_accuracy"]])


def mean_consensus(row: dict) -> float:
    """Mean consensus distance over eval epochs and seeds."""
    return float(np.mean(row["consensus_distance"]))


def mean_kl_trace(row: dict) -> np.ndarray:
    """Seed-averaged per-epoch mean KL-to-target trace: [epochs]."""
    return np.mean(row["kl_trace"], axis=0)


def total_comm_mb(row: dict) -> float:
    """Seed-averaged total communication volume of the run, MB."""
    return float(np.mean(np.sum(row["comm_mb"], axis=1)))
