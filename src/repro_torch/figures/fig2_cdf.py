"""Paper Fig. 2: CDFs of final per-vehicle accuracy (SP on grid vs random).

Reproduces the simulation-study finding: per-vehicle accuracy spreads widely,
and the random topology is worse than the grid. Registered as campaign
figure ``fig2``; scenario runs come from the content-hashed results store
(shared with fig3, which uses the same SP runs)."""
from __future__ import annotations

import numpy as np

from ..launch import campaign as campaign_lib
from ..launch.campaign import Check, FigureSpec

from .common import figure_csv, run_figure


def _derive(spec, rows):
    out = []
    for key, row in rows.items():
        accs = campaign_lib.final_vehicle_accuracies(row)
        p10, p50, p90 = np.percentile(accs, [10, 50, 90])
        out.append({
            "figure": spec.name, "topology": key[1], "dataset": key[0],
            "acc_p10": float(p10), "acc_p50": float(p50),
            "acc_p90": float(p90), "spread": float(p90 - p10),
        })
    return out


def _check(spec, rows):
    p50 = {}
    spreads = {}
    for key, row in rows.items():
        accs = campaign_lib.final_vehicle_accuracies(row)
        p50[key[1]] = float(np.percentile(accs, 50))
        spreads[key[1]] = float(np.percentile(accs, 90) -
                                np.percentile(accs, 10))
    return [
        Check("per_vehicle_spread_positive",
              all(s > 0.005 for s in spreads.values()),
              "SP leaves a wide per-vehicle spread: " +
              " ".join(f"{n}={s:.4f}" for n, s in spreads.items())),
        Check("grid_median_geq_random",
              p50["grid"] >= p50["random"] - 0.02,
              f"grid p50={p50['grid']:.4f} random p50={p50['random']:.4f}"),
    ]


FIGURE = campaign_lib.register_figure(FigureSpec(
    name="fig2",
    title="Fig. 2 — CDF of final per-vehicle accuracy (SP, grid vs random)",
    dataset="mnist", road_nets=("grid", "random"), algorithms=("sp",),
    derive=_derive, check=_check))


def main() -> list[str]:
    return figure_csv(run_figure("fig2"))


if __name__ == "__main__":
    print("\n".join(main()))
