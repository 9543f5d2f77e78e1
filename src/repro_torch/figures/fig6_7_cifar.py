"""Paper Figs. 6-7: average accuracy on CIFAR-10, DFL-DDS vs DFL vs SP,
under Balanced&non-IID (Fig. 6) and Unbalanced&IID (Fig. 7), grid network.

Registered as campaign figures ``fig6`` and ``fig7``. Not in the default
smoke figure set (six extra CIFAR scenarios); run with ``python -m
repro_torch.figures.run --campaign smoke --figures fig6 fig7`` or at the full
tier."""
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
            "figure": spec.name, "distribution": key[2], "algorithm": key[3],
            "final_acc_mean": row["final_accuracy_mean"],
            "final_acc_std": row["final_accuracy_std"],
            "kl_final": float(kl[-1]),
            "kl_gain": metrics.diversity_gain(kl),
            "comm_mb": campaign_lib.total_comm_mb(row),
        })
    return out


def _check(spec, rows):
    return accuracy_ordering_checks(rows, group_axis=2)


FIG6 = campaign_lib.register_figure(FigureSpec(
    name="fig6",
    title="Fig. 6 — CIFAR-10 accuracy, Balanced & non-IID (grid)",
    dataset="cifar10", distributions=("balanced_noniid",),
    algorithms=("dds", "dfl", "sp"), derive=_derive, check=_check))

FIG7 = campaign_lib.register_figure(FigureSpec(
    name="fig7",
    title="Fig. 7 — CIFAR-10 accuracy, Unbalanced & IID (grid)",
    dataset="cifar10", distributions=("unbalanced_iid",),
    algorithms=("dds", "dfl", "sp"), derive=_derive, check=_check))


def main() -> list[str]:
    return figure_csv(run_figure("fig6")) + figure_csv(run_figure("fig7"))


if __name__ == "__main__":
    print("\n".join(main()))
