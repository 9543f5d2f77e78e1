"""Report generator: render campaign results (launch.campaign) to markdown.

Counterpart of ``repro.launch.report``. The report is written only to a path
the caller gives (``python -m repro_torch.figures.run --campaign <name>
--results-md PATH``) — figure tables, the pass/fail ordering checks, and
per-scenario wall time / traffic, all read back from results-store rows;
nothing is re-simulated. The reference's committed ``docs/RESULTS.md`` is
never written by the port.
"""
from __future__ import annotations

import os
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # no runtime import: campaign imports this module
    from .campaign import CampaignSpec, FigureResult


def fmt_cell(v) -> str:
    """Shared table-cell formatter (markdown report + benchmark CSV)."""
    if isinstance(v, float):
        return f"{v:.4f}" if abs(v) < 1000 else f"{v:.1f}"
    return str(v)


def _table(rows: list[dict]) -> list[str]:
    if not rows:
        return ["*(no rows)*"]
    cols = list(rows[0].keys())
    lines = ["| " + " | ".join(cols) + " |",
             "|" + "|".join("---" for _ in cols) + "|"]
    for row in rows:
        lines.append("| " + " | ".join(fmt_cell(row.get(c, "")) for c in cols) + " |")
    return lines


def render_results(spec: "CampaignSpec",
                   results: list["FigureResult"]) -> str:
    base = spec.base
    n_checks = sum(len(fr.checks) for fr in results)
    n_passed = sum(c.passed for fr in results for c in fr.checks)
    # unique scenario rows across figures (shared runs counted once)
    seen: dict[str, dict] = {}
    for fr in results:
        for row in fr.scenario_rows:
            seen.setdefault(row["spec_hash"], row)
    total_wall = sum(r["wall_time_s"] for r in seen.values())

    lines = [
        f"# Results — `{spec.name}` campaign",
        "",
        "Generated by `python -m repro_torch.figures.run --campaign "
        f"{spec.name}` (the PyTorch port) — do not edit by hand.",
        "",
        f"- engine path: `run_sweep` → `run_seeds` (seed-stacked window "
        f"loop, backend=`{base.backend}`, mixing_backend="
        f"`{base.mixing_backend}`, device=`{base.device}`)",
        f"- scale tier: {base.num_vehicles} vehicles x {base.epochs} epochs, "
        f"E={base.local_steps}, B={base.batch_size}, lr={base.lr}",
        f"- seeds: {list(spec.seeds)} (all scalars mean ± std over seeds)",
        f"- results store: `{spec.store_path}`",
        f"- ordering checks: **{n_passed}/{n_checks} passed**",
        "",
    ]

    for fr in results:
        lines += [f"## {fr.spec.title}", ""]
        lines += _table(fr.table)
        lines += [""]
        if fr.checks:
            lines += ["**Checks**", ""]
            for c in fr.checks:
                mark = "✅" if c.passed else "❌"
                detail = f" — {c.detail}" if c.detail else ""
                lines.append(f"- {mark} `{c.name}`{detail}")
            lines += [""]

    cost_rows = [{
        "dataset": r["key"][0], "road_net": r["key"][1],
        "distribution": r["key"][2], "algorithm": r["key"][3],
        "seeds": len(r["seeds"]),
        "final_acc": f'{r["final_accuracy_mean"]:.4f}'
                     f' ± {r["final_accuracy_std"]:.4f}',
        "comm_mb_per_seed": f'{np.mean(np.sum(r["comm_mb"], axis=1)):.2f}',
        "wall_s": f'{r["wall_time_s"]:.1f}',
    } for r in seen.values()]
    lines += [
        "## Scenario runs",
        "",
        f"{len(seen)} unique scenario runs (figures share cached runs via "
        f"the content-hashed store); total wall time "
        f"{total_wall:.1f}s.",
        "",
    ]
    lines += _table(cost_rows)
    lines += [""]
    return "\n".join(lines)


def write_results(spec: "CampaignSpec", results: list["FigureResult"],
                  path: str) -> str:
    md = render_results(spec, results)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(md)
    return path
