"""Paper Fig. 9: global epochs needed to reach target average accuracy on
MNIST (targets scaled to the synthetic task's difficulty). Registered as
campaign figure ``fig9``; its scenarios are fig8's grid runs."""
from __future__ import annotations

import numpy as np

from ..fed import metrics
from ..launch import campaign as campaign_lib
from ..launch.campaign import Check, FigureSpec

from .common import figure_csv, run_figure


def _targets_and_epochs(rows):
    """Calibrate targets off the best seed-mean curve (the paper used
    90/92/95% on real MNIST); map eval-index hits back to epoch numbers."""
    curves = {}
    for key, row in rows.items():
        curves[key[3]] = campaign_lib.seed_mean_curve(row)
    best = max(float(np.max(c)) for _, c in curves.values())
    targets = [round(best * f, 3) for f in (0.90, 0.95, 0.99)]
    epochs = {}
    for tgt in targets:
        for algo, (eval_epochs, curve) in curves.items():
            idx = metrics.epochs_to_target(curve, tgt)
            epochs[(tgt, algo)] = (eval_epochs[idx - 1]
                                   if idx is not None else None)
    return targets, epochs


def _derive(spec, rows):
    targets, epochs = _targets_and_epochs(rows)
    return [{
        "figure": spec.name, "target_acc": tgt, "algorithm": algo,
        "epochs_to_target": epochs[(tgt, algo)] or "never",
    } for tgt in targets for algo in spec.algorithms]


def _check(spec, rows):
    targets, epochs = _targets_and_epochs(rows)
    lo = targets[0]
    inf = float("inf")
    e = {a: (epochs[(lo, a)] if epochs[(lo, a)] is not None else inf)
         for a in spec.algorithms}
    ok = e["dds"] < inf and e["dds"] <= e["dfl"] and e["dds"] <= e["sp"]
    return [Check(
        "dds_fastest_to_lowest_target", ok,
        f"target={lo}: dds={e['dds']} dfl={e['dfl']} sp={e['sp']} epochs")]


FIGURE = campaign_lib.register_figure(FigureSpec(
    name="fig9",
    title="Fig. 9 — epochs to reach target accuracy (MNIST, grid)",
    dataset="mnist", road_nets=("grid",), algorithms=("dds", "dfl", "sp"),
    derive=_derive, check=_check))


def main() -> list[str]:
    return figure_csv(run_figure("fig9"))


if __name__ == "__main__":
    print("\n".join(main()))
