"""Paper Fig. 3: Pearson correlation between per-vehicle accuracy and
state-vector entropy, per global epoch (SP, grid and random topologies).

The paper's claim: a strong positive correlation — unlucky vehicles fail to
diversify their data sources. Registered as campaign figure ``fig3``; its
scenarios are fig2's SP runs, deduplicated through the results store."""
from __future__ import annotations

import numpy as np

from ..fed import metrics
from ..launch import campaign as campaign_lib
from ..launch.campaign import Check, FigureSpec

from .common import figure_csv, run_figure


def _epoch_pearsons(row) -> list[float]:
    """Seed-mean Pearson(per-vehicle accuracy, per-vehicle entropy) at each
    eval epoch."""
    n_veh = len(row["vehicle_accuracy"][0][0])
    out = []
    for i in range(len(row["epochs_evaluated"])):
        per_seed = [metrics.pearson(np.asarray(va[i]),
                                    np.asarray(en[i])[:n_veh])
                    for va, en in zip(row["vehicle_accuracy"], row["entropy"])]
        out.append(float(np.mean(per_seed)))
    return out


def _final_pooled_pearson(row) -> float:
    """Final-epoch correlation pooled over seeds x vehicles — the paper's
    scatter-plot statistic. S*K points resolve the sign reliably at smoke
    scale, where an 8-vehicle per-seed correlation is noise."""
    n_veh = len(row["vehicle_accuracy"][0][0])
    accs = np.concatenate([np.asarray(va[-1])
                           for va in row["vehicle_accuracy"]])
    ents = np.concatenate([np.asarray(en[-1])[:n_veh]
                           for en in row["entropy"]])
    return metrics.pearson(accs, ents)


def _derive(spec, rows):
    out = []
    for key, row in rows.items():
        for epoch, p in zip(row["epochs_evaluated"], _epoch_pearsons(row)):
            out.append({"figure": spec.name, "topology": key[1],
                        "epoch": epoch, "pearson_acc_vs_entropy": p})
        out.append({"figure": spec.name, "topology": key[1],
                    "epoch": "final_pooled",
                    "pearson_acc_vs_entropy": _final_pooled_pearson(row)})
    return out


def _check(spec, rows):
    finals = {key[1]: _final_pooled_pearson(row) for key, row in rows.items()}
    return [Check(
        "final_pooled_pearson_positive",
        all(p > 0 for p in finals.values()),
        "accuracy correlates positively with state-vector diversity "
        "(final epoch, pooled over seeds x vehicles): " +
        " ".join(f"{n}={p:.4f}" for n, p in finals.items()))]


FIGURE = campaign_lib.register_figure(FigureSpec(
    name="fig3",
    title="Fig. 3 — per-vehicle accuracy vs state-vector entropy "
          "(Pearson, SP)",
    dataset="mnist", road_nets=("grid", "random"), algorithms=("sp",),
    derive=_derive, check=_check))


def main() -> list[str]:
    return figure_csv(run_figure("fig3"))


if __name__ == "__main__":
    print("\n".join(main()))
