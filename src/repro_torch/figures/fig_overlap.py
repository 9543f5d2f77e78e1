"""Overlap figure: DFL-DDS with synchronous vs delayed (double-buffered)
gossip on the MNIST grid scenario. Not a paper figure — it qualifies the
engine's ``overlap="delayed"`` mode: one-round-stale neighbour
payloads let the exchange run concurrently with local training, and this
figure shows the accuracy cost of that staleness is small at smoke scale.
The sync case IS fig8's grid/dds run (same content hash, shared store row);
only the ``dds@delayed`` variant adds a scenario."""
from __future__ import annotations

from ..launch import campaign as campaign_lib
from ..launch.campaign import Check, FigureSpec

from .common import figure_csv, run_figure

TOL = 0.05  # staleness-induced final-accuracy slack vs synchronous gossip


def _by_mode(spec, rows):
    out = {}
    for key, row in rows.items():
        _, _, variant = key[3].partition("@")
        out[variant or "sync"] = row
    return out


def _derive(spec, rows):
    return [{
        "figure": spec.name, "overlap": mode,
        "final_acc_mean": row["final_accuracy_mean"],
        "final_acc_std": row["final_accuracy_std"],
        "comm_mb": campaign_lib.total_comm_mb(row),
        "wall_time_s": row["wall_time_s"],
    } for mode, row in _by_mode(spec, rows).items()]


def _check(spec, rows):
    modes = _by_mode(spec, rows)
    sync = modes["sync"]["final_accuracy_mean"]
    delayed = modes["delayed"]["final_accuracy_mean"]
    return [
        Check("delayed_learns", delayed > 0.15,
              f"delayed final acc {delayed:.4f} vs 0.10 chance"),
        Check("delayed_within_tol_of_sync", delayed >= sync - TOL,
              f"sync={sync:.4f} delayed={delayed:.4f} tol={TOL}"),
    ]


FIGURE = campaign_lib.register_figure(FigureSpec(
    name="fig_overlap",
    title="Overlap — DFL-DDS accuracy, synchronous vs delayed gossip "
          "(MNIST, grid)",
    dataset="mnist", road_nets=("grid",), algorithms=("dds", "dds@delayed"),
    derive=_derive, check=_check))


def main() -> list[str]:
    return figure_csv(run_figure("fig_overlap"))


if __name__ == "__main__":
    print("\n".join(main()))
