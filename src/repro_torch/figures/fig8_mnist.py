"""Paper Fig. 8: average accuracy on MNIST under grid / random / spider road
networks, DFL-DDS vs DFL vs SP (Balanced & non-IID). Registered as campaign
figure ``fig8``; figs 9/10 reuse its grid scenarios via the results store."""
from __future__ import annotations

from ..fed import metrics
from ..launch import campaign as campaign_lib
from ..launch.campaign import FigureSpec

from .common import accuracy_ordering_checks, figure_csv, run_figure


def _derive(spec, rows):
    out = []
    for key, row in rows.items():
        kl = campaign_lib.mean_kl_trace(row)
        out.append({
            "figure": spec.name, "topology": key[1], "algorithm": key[3],
            "final_acc_mean": row["final_accuracy_mean"],
            "final_acc_std": row["final_accuracy_std"],
            "kl_final": float(kl[-1]),
            # positive = the run moved its state vectors TOWARD the global
            # data distribution (diversified its sources, Eq. 9)
            "kl_gain": metrics.diversity_gain(kl),
            "comm_mb": campaign_lib.total_comm_mb(row),
        })
    return out


def _check(spec, rows):
    return accuracy_ordering_checks(rows)


FIGURE = campaign_lib.register_figure(FigureSpec(
    name="fig8",
    title="Fig. 8 — MNIST accuracy across road networks "
          "(DFL-DDS vs DFL vs SP)",
    dataset="mnist", road_nets=("grid", "random", "spider"),
    algorithms=("dds", "dfl", "sp"),
    derive=_derive, check=_check))


def main() -> list[str]:
    return figure_csv(run_figure("fig8"))


if __name__ == "__main__":
    print("\n".join(main()))
