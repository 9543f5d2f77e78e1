"""Paper Fig. 10: consensus distance Xi_t^2, DFL-DDS vs DFL (lower = faster
agreement between vehicle models). Registered as campaign figure ``fig10``
with the paper's two cases paired explicitly: MNIST/Balanced&non-IID and
CIFAR-10/Unbalanced&IID. The MNIST case reuses fig8's grid runs."""
from __future__ import annotations

from ..launch import campaign as campaign_lib
from ..launch.campaign import Check, FigureSpec

from .common import figure_csv, run_figure

CASES = (
    ("mnist", "grid", "balanced_noniid", "dds"),
    ("mnist", "grid", "balanced_noniid", "dfl"),
    ("cifar10", "grid", "unbalanced_iid", "dds"),
    ("cifar10", "grid", "unbalanced_iid", "dfl"),
)


def _derive(spec, rows):
    return [{
        "figure": spec.name, "case": f"{key[0]}/{key[2]}", "algorithm": key[3],
        "mean_consensus": campaign_lib.mean_consensus(row),
        "final_acc_mean": row["final_accuracy_mean"],
        "kl_final": float(campaign_lib.mean_kl_trace(row)[-1]),
    } for key, row in rows.items()]


def _check(spec, rows):
    cases: dict[str, dict[str, float]] = {}
    for key, row in rows.items():
        cases.setdefault(f"{key[0]}/{key[2]}", {})[key[3]] = (
            campaign_lib.mean_consensus(row))
    return [
        Check(f"{case}:dds_consensus_leq_dfl",
              vals["dds"] <= vals["dfl"] * 1.1,
              f"dds={vals['dds']:.5f} dfl={vals['dfl']:.5f} (10% slack)")
        for case, vals in cases.items()
    ]


FIGURE = campaign_lib.register_figure(FigureSpec(
    name="fig10",
    title="Fig. 10 — consensus distance, DFL-DDS vs DFL",
    cases=CASES, derive=_derive, check=_check))


def main() -> list[str]:
    return figure_csv(run_figure("fig10"))


if __name__ == "__main__":
    print("\n".join(main()))
