"""Shared campaign plumbing for the port's figures: scale tiers, the dataset
cache, and CSV rendering of figure results.

A copy of the reference's ``benchmarks/common.py`` on the port's packages.
The default ``smoke`` tier is K=8 vehicles / 15 epochs / E=4 / B=32 over 3
seeds — every scenario runs multi-seed through the seed-stacked engine
(``run_sweep`` -> ``run_seeds``). The ``full`` tier is the paper's Table II
scale. Runs live on ``device`` (``cuda`` by default; it never falls back).

Scenario runs are cached in the port's own JSONL results store
(``results/campaign_<tier>_torch.jsonl`` by default) keyed by content hash;
the reference's store and report are never written.
"""
from __future__ import annotations

from dataclasses import replace

from ..data import datasets as data_lib
from ..data.synthetic import synthetic_cifar10, synthetic_mnist
from ..fed.engine import SimulationConfig
from ..launch import campaign as campaign_lib
from ..launch import report as report_lib

# the acceptance set: every figure the smoke campaign must regenerate
# (fig6/fig7 are registered too — CIFAR-10 curves — but off by default
# because two extra distributions x three algorithms double the CPU cost;
# add them with --figures or run the full tier). fig_overlap rides along
# cheaply: its sync case is fig8's grid/dds store row, so it adds exactly
# one scenario (dds@delayed).
DEFAULT_FIGURES = ("fig2", "fig3", "fig8", "fig9", "fig10", "fig_overlap")
SMOKE_SEEDS = (0, 1, 2)

_DATASETS: dict[tuple[str, str], object] = {}


def dataset_factory(tier: str = "smoke"):
    """Per-tier dataset loader with in-process caching. ``smoke`` uses small
    synthetic splits; ``full`` goes through ``data.datasets.load_dataset``
    (real MNIST/CIFAR files when ``REPRO_DATA_DIR`` has them)."""

    def factory(name: str):
        key = (tier, name)
        if key not in _DATASETS:
            if tier == "full":
                _DATASETS[key] = data_lib.load_dataset(name, seed=0)
            else:
                maker = synthetic_mnist if "mnist" in name else synthetic_cifar10
                _DATASETS[key] = maker(n_train=6_000, n_test=1_000)
        return _DATASETS[key]

    return factory


def tier_base(tier: str = "smoke", device: str = "cuda") -> SimulationConfig:
    if tier == "smoke":
        # the reference's smoke scale: dds/dfl learn past 0.2 by epoch 15
        # while sp stays near chance, so the ordering checks measure signal
        return SimulationConfig(
            num_vehicles=8, epochs=15, local_steps=4, batch_size=32,
            eval_every=3, eval_samples=400, p1_steps=60, lr=0.15,
            device=device)
    if tier == "full":
        # paper Table II: K=100, 300 epochs, E=8, B=80
        return SimulationConfig(device=device)
    raise ValueError(f"unknown tier {tier!r} (smoke|full)")


def default_store(tier: str) -> str:
    """The port's store for a tier — never the reference's file."""
    return f"results/campaign_{tier}_torch.jsonl"


def campaign_spec(tier: str = "smoke", figures=DEFAULT_FIGURES,
                  seeds=SMOKE_SEEDS, store_path: str | None = None,
                  results_md: str | None = None, device: str = "cuda",
                  **base_overrides) -> campaign_lib.CampaignSpec:
    """Build the tier's CampaignSpec; ``base_overrides`` patch the base
    config (e.g. ``num_vehicles=6, epochs=4`` for test-speed runs)."""
    base = tier_base(tier, device)
    if base_overrides:
        base = replace(base, **base_overrides)
    return campaign_lib.CampaignSpec(
        name=tier, figures=tuple(figures), seeds=tuple(seeds), base=base,
        dataset_factory=dataset_factory(tier),
        store_path=store_path or default_store(tier),
        results_md=results_md)


def run_figure(name: str, tier: str = "smoke",
               device: str = "cuda") -> campaign_lib.FigureResult:
    """Run ONE registered figure at the given tier (store-cached)."""
    return campaign_lib.run_campaign(
        campaign_spec(tier, figures=(name,), device=device))[0]


def csv_row(*fields) -> str:
    return ",".join(str(f) for f in fields)


def figure_csv(fr: campaign_lib.FigureResult) -> list[str]:
    """The benchmark-suite CSV contract: the figure table + check rows."""
    rows = []
    if fr.table:
        cols = list(fr.table[0].keys())
        rows.append(csv_row(*cols))
        rows += [csv_row(*(report_lib.fmt_cell(r.get(c, "")) for c in cols))
                 for r in fr.table]
    for c in fr.checks:
        rows.append(csv_row("CHECK", c.name, "PASS" if c.passed else "FAIL",
                            c.detail.replace(",", ";")))
    return rows


def accuracy_ordering_checks(rows, tol: float = 0.02,
                             group_axis: int = 1) -> list[campaign_lib.Check]:
    """The paper's headline ordering — DFL-DDS final accuracy >= DFL >= SP
    (within ``tol``) — checked per group (road net or distribution)."""
    groups: dict[str, dict[str, float]] = {}
    for key, row in rows.items():
        groups.setdefault(key[group_axis], {})[key[3]] = row["final_accuracy_mean"]
    checks = []
    for group, finals in groups.items():
        for other in ("dfl", "sp"):
            if "dds" in finals and other in finals:
                ok = finals["dds"] >= finals[other] - tol
                checks.append(campaign_lib.Check(
                    f"{group}:dds_geq_{other}", ok,
                    f"dds={finals['dds']:.4f} {other}={finals[other]:.4f} "
                    f"tol={tol}"))
    return checks
