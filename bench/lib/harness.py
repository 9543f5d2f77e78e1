"""The benchmark's harness: one cell, one run, one result line.

A run: set-up (imports, CUDA, the driver's inputs and warm-up: ``setup_s``
from the process's start), a window of ``--seconds`` in which the driver's
``call()`` repeats, the peak memory, then the driver's ``finish()``, which
frees the program's state and returns the numbers the reference comparison
gave; each is held to the cell's limit.

With ``--trace 0`` the metrics are the cell's end-to-end metrics: ``setup_s``
and the rate of the work the calls did over the whole window. With
``--trace 1`` the driver attaches the program's phase timer, the first
``trace_calls`` calls of the window run under ``torch.profiler``, and the
cell's per-layer metrics are read by ``bench/metrics/<name>.py`` (``read(obs)``
returns a number, or None where it finds nothing to read).

A driver (``bench/drivers/<name>.py``) defines ``Driver(run)`` with ``call()``
(one unit of the window's work: ``{"units": ..., "epochs" | "rounds": ...}``),
``spans_ms()`` and ``finish()``.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import trace as trace_lib

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(name: str, bench: dict | None = None) -> tuple[dict, dict, dict]:
    """``(BENCHMARK.json entry, workload file, configuration file)`` of a cell."""
    bench = bench or manifest()
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return entry, load_json(BENCH / "workloads" / f"{name}.json"), load_json(ROOT / config["file"])


def metrics_of(bench: dict, kind: str, cell: str) -> list[dict]:
    """The cell's metrics of ``kind`` (``end_to_end`` or ``per_layer``)."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def load_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def refuse_forbidden() -> None:
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {', '.join(found)}: no result")


def device_line(chips: int) -> str:
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=20).stdout.split("\n")[0]
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return (f"device: {name}; {torch.cuda.device_count()} visible, {chips} used; "
            f"power limit {limit.strip() or 'unknown'}")


def run_cell(name: str, seed: int, seconds: float, traced: bool, device,
             start: float | None = None, overrides: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result (the line's object).

    ``overrides`` replaces parts of the cell's files (``traffic``, ``config``,
    ``limits``, ``trace_calls``): the CPU rehearsal's smaller sizes.
    Raises ``SystemExit`` (no result) where a module named in ``FORBIDDEN``
    is loaded once the window has closed, looked for again after the
    comparison and the readers."""
    start = time.perf_counter() if start is None else start
    bench = manifest()
    entry, cell, config = cell_files(name, bench)
    overrides = overrides or {}
    cell = dict(cell, **{k: v for k, v in overrides.items() if k != "config"})
    config = dict(config, **overrides.get("config", {}))
    run = SimpleNamespace(device=torch.device(device), seed=int(seed), trace=traced,
                          cell=cell, config=config)
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.set_device(run.device)
    driver_mod = importlib.import_module(f"bench.drivers.{cell['driver']}")
    driver = driver_mod.Driver(run)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - start

    tracer = trace_lib.Tracer(traced)
    trace_calls = cell.get("trace_calls", 1) if traced else 0
    totals = {"units": 0.0, "epochs": 0, "rounds": 0, "calls": 0}
    span_base = None
    t0 = time.perf_counter()
    while True:
        if totals["calls"] < trace_calls:
            if totals["calls"] == 0:
                tracer.__enter__()
            out = tracer.record(driver.call)
            tracer.units += out["units"]
            if totals["calls"] + 1 == trace_calls:
                tracer.__exit__(None, None, None)
                # the phase spans are read over the calls after the profiled
                # ones, which the profiler's own cost does not slow
                span_base = dict(totals, calls=totals["calls"] + 1,
                                 units=totals["units"] + out["units"],
                                 epochs=totals["epochs"] + out.get("epochs", 0),
                                 rounds=totals["rounds"] + out.get("rounds", 0),
                                 spans=driver.spans_ms())
        else:
            out = driver.call()
        totals["calls"] += 1
        for key in ("units", "epochs", "rounds"):
            totals[key] += out.get(key, 0)
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    tracer.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    refuse_forbidden()

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
                   "count": entry["chips"], "memory_peak_bytes": int(memory_peak)}
    metrics, breakdown = {}, None
    if traced:
        summary = tracer.summary()
        spans, counts = driver.spans_ms(), dict(totals)
        if span_base is not None and totals["calls"] > span_base["calls"]:
            spans = {n: ms - span_base["spans"].get(n, 0.0) for n, ms in spans.items()}
            counts = {k: totals[k] - span_base[k] for k in totals}
        obs = SimpleNamespace(cell=cell, config=config, spans_ms=spans, span_counts=counts,
                              host_ms=dict(getattr(getattr(driver, "hooks", None), "host_ms", {})),
                              window_s=window_s, trace=summary, **totals)
        for m in metrics_of(bench, "per_layer", name):
            value = load_reader(m["name"])(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        top = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
        breakdown = {"device_ops": [[n, s] for n, (_, s) in top],
                     "idle_gaps": summary["idle_gaps"]}
    else:
        for m in metrics_of(bench, "end_to_end", name):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] == cell["rate_metric"]:
                metrics[m["name"]] = {"value": totals["units"] / window_s, "unit": m["unit"]}
            else:
                raise ValueError(f"{name}: no reading for end-to-end metric {m['name']}")
    numbers = driver.finish()
    checks, correct = {}, True
    for key, value in numbers.items():
        limit = cell["limits"].get(key)
        ok = limit is not None and not math.isnan(value) and value <= limit
        correct = correct and ok
        checks[key] = {"value": value, "limit": limit}
    refuse_forbidden()
    result = {"correct": correct, "attempted": totals["calls"], "failed": 0,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv: list[str], start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    entry = next((w for w in manifest()["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    print(device_line(entry["chips"]), file=sys.stderr, flush=True)
    torch.cuda.init()
    print(f"setup: imports and CUDA {time.perf_counter() - start:.3f} s", file=sys.stderr)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", start)
    for key, c in result["checks"].items():
        print(f"check {key} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
