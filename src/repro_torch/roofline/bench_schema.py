"""Schema validation for the committed benchmark artifacts.

A copy of ``repro.roofline.bench_schema`` (pure Python): the same
validators, names and messages, so the port's cost model
(``repro_torch.roofline.scenario_cost``) replays the same files under the
same contract without importing the reference package.

BENCH_engine.json / BENCH_scale.json / BENCH_collective.json are
machine-readable measurements the cost-model validation suite
(tests/test_scenario_cost.py) replays pair by pair — a silently drifted key
or unit there would turn the ranking assertions into no-ops. These
lightweight validators pin the contract: required keys, types, and unit
sanity ranges (rates positive, ratios positive, device/fleet counts >= 1).
``benchmarks/engine_backends.py``, ``benchmarks/engine_scale.py`` and
``benchmarks/collective_sweep.py`` produce the files;
tests/test_bench_schema.py holds the committed copies to this schema.
"""
from __future__ import annotations

import json
from typing import Any

_NUMBER = (int, float)

# required result-row keys -> (type, validator) — names carry the units
# (epochs_per_s, peak_rss_mb, contact_window_mb)
ENGINE_ROW_SCHEMA: dict[str, tuple] = {
    "num_vehicles": (int, lambda v: v >= 1),
    "epochs": (int, lambda v: v >= 1),
    "vehicle_shards": (int, lambda v: v >= 1),
    "vmap_epochs_per_s": (_NUMBER, lambda v: v > 0),
    "shard_map_epochs_per_s": (_NUMBER, lambda v: v > 0),
    "shard_vs_vmap": (_NUMBER, lambda v: v > 0),
}

COLLECTIVE_ROW_SCHEMA: dict[str, tuple] = {
    "collective": (str, lambda v: v in ("all_gather", "psum_scatter_per_leaf",
                                        "psum_scatter_bucketed")),
    "payload_mb": (_NUMBER, lambda v: v > 0),
    "time_s": (_NUMBER, lambda v: v > 0),
    "wire_mb": (_NUMBER, lambda v: v >= 0),
    "gbytes_per_s": (_NUMBER, lambda v: v > 0),
}

SCALE_ROW_SCHEMA: dict[str, tuple] = {
    "num_vehicles": (int, lambda v: v >= 1),
    "contact_format": (str, lambda v: v in ("dense", "sparse")),
    "epochs": (int, lambda v: v >= 1),
    "d_max": (int, lambda v: v >= 0),
    "epochs_per_s": (_NUMBER, lambda v: v > 0),
    "peak_rss_mb": (_NUMBER, lambda v: v > 0),
    "contact_window_mb": (_NUMBER, lambda v: v >= 0),
}


class BenchSchemaError(ValueError):
    """A benchmark artifact violates the committed schema."""


def _check_row(row: Any, schema: dict[str, tuple], where: str) -> None:
    if not isinstance(row, dict):
        raise BenchSchemaError(f"{where}: result row is not an object")
    for key, (typ, ok) in schema.items():
        if key not in row:
            raise BenchSchemaError(f"{where}: missing required key {key!r}")
        v = row[key]
        if isinstance(v, bool) or not isinstance(v, typ):
            raise BenchSchemaError(
                f"{where}: {key}={v!r} has type {type(v).__name__}, "
                f"expected {typ}")
        if not ok(v):
            raise BenchSchemaError(f"{where}: {key}={v!r} out of range")


def _check_report(report: Any, benchmark: str, row_schema: dict,
                  extra_top: tuple[str, ...] = ()) -> dict:
    if not isinstance(report, dict):
        raise BenchSchemaError(f"{benchmark}: report is not an object")
    for key in ("benchmark", "workload", "results") + extra_top:
        if key not in report:
            raise BenchSchemaError(f"{benchmark}: missing top-level {key!r}")
    if report["benchmark"] != benchmark:
        raise BenchSchemaError(
            f"expected benchmark={benchmark!r}, got {report['benchmark']!r}")
    if not isinstance(report["results"], list) or not report["results"]:
        raise BenchSchemaError(f"{benchmark}: results must be non-empty")
    for i, row in enumerate(report["results"]):
        _check_row(row, row_schema, f"{benchmark}.results[{i}]")
    return report


def validate_engine_report(report: Any) -> dict:
    """Validate a BENCH_engine.json report (vmap vs shard_map pairs)."""
    _check_report(report, "engine_backends", ENGINE_ROW_SCHEMA,
                  extra_top=("device_count",))
    dc = report["device_count"]
    if not isinstance(dc, int) or dc < 1:
        raise BenchSchemaError(f"engine_backends: device_count={dc!r}")
    for i, r in enumerate(report["results"]):
        measured = r["shard_map_epochs_per_s"] / r["vmap_epochs_per_s"]
        if abs(measured - r["shard_vs_vmap"]) > 0.01 * max(measured, 1.0):
            raise BenchSchemaError(
                f"engine_backends.results[{i}]: shard_vs_vmap="
                f"{r['shard_vs_vmap']} inconsistent with the rates "
                f"({measured:.3f})")
    return report


def validate_scale_report(report: Any) -> dict:
    """Validate a BENCH_scale.json report (dense vs sparse cells). Every K
    must carry both formats, and sparse cells a resolved d_max >= 1."""
    _check_report(report, "engine_scale", SCALE_ROW_SCHEMA,
                  extra_top=("sparse_vs_dense",))
    cells = {(r["num_vehicles"], r["contact_format"])
             for r in report["results"]}
    for k in {r["num_vehicles"] for r in report["results"]}:
        for fmt in ("dense", "sparse"):
            if (k, fmt) not in cells:
                raise BenchSchemaError(
                    f"engine_scale: K={k} missing the {fmt} cell")
    for i, r in enumerate(report["results"]):
        if r["contact_format"] == "sparse" and r["d_max"] < 1:
            raise BenchSchemaError(
                f"engine_scale.results[{i}]: sparse cell with d_max="
                f"{r['d_max']}")
    return report


def validate_collective_report(report: Any) -> dict:
    """Validate a BENCH_collective.json report (benchmarks/collective_sweep):
    sized-collective rows plus the fitted ``derived`` block the cost model's
    overlap-aware collective term is calibrated from (in the reference:
    ``repro.roofline.scenario_cost.profile_from_collective_bench``)."""
    _check_report(report, "collective_sweep", COLLECTIVE_ROW_SCHEMA,
                  extra_top=("device_count", "axis_size", "derived"))
    for key in ("device_count", "axis_size"):
        v = report[key]
        if isinstance(v, bool) or not isinstance(v, int) or v < 1:
            raise BenchSchemaError(f"collective_sweep: {key}={v!r}")
    derived = report["derived"]
    if not isinstance(derived, dict):
        raise BenchSchemaError("collective_sweep: derived is not an object")
    for key, ok in (("collective_launch_s", lambda v: v > 0),
                    ("collective_bytes_per_s", lambda v: v > 0),
                    ("overlap_fraction", lambda v: 0.0 <= v <= 1.0)):
        if key not in derived:
            raise BenchSchemaError(
                f"collective_sweep.derived: missing {key!r}")
        v = derived[key]
        if isinstance(v, bool) or not isinstance(v, _NUMBER) or not ok(v):
            raise BenchSchemaError(
                f"collective_sweep.derived: {key}={v!r} out of range")
    covered = {r["collective"] for r in report["results"]}
    for name in ("psum_scatter_per_leaf", "psum_scatter_bucketed"):
        if name not in covered:
            raise BenchSchemaError(
                f"collective_sweep: no {name!r} rows — the per-leaf vs "
                f"bucketed comparison is the point of the sweep")
    return report


def load_engine_report(path: str) -> dict:
    with open(path) as f:
        return validate_engine_report(json.load(f))


def load_scale_report(path: str) -> dict:
    with open(path) as f:
        return validate_scale_report(json.load(f))


def load_collective_report(path: str) -> dict:
    with open(path) as f:
        return validate_collective_report(json.load(f))
