#!/usr/bin/env python3
"""Where a DFL-DDS round spends its time on the GPU (the PyTorch/CUDA port).

    python3 scripts/torch_profile_round.py [--epochs 2] [--contact-format sparse]
                                           [--vehicles 100] [--out profile_out]

Runs ``run_simulation`` at the paper's MNIST configuration for one warm-up
epoch, then ``--epochs`` epochs un-profiled (wall time per epoch, per-phase
CUDA-event split from ``repro_torch.profiling``, the P1 solve's route: its
``eg_solve`` launches and ``core.kl_solver.solve_counts``) and once more under
``torch.profiler`` (kernels by total device time, launches per epoch, the
device-busy share). Writes the table under ``--out`` (``--trace``: and a
chrome trace).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core import kl_solver  # noqa: E402
from repro_torch.data import datasets as data_lib  # noqa: E402
from repro_torch.fed import engine  # noqa: E402
from repro_torch.fed.simulator import SimulationConfig  # noqa: E402
from repro_torch.kernels.kl_simplex import kernel as kl_kernel  # noqa: E402
from repro_torch.profiling import PhaseTimer  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--vehicles", type=int, default=100)
    ap.add_argument("--contact-format", default="sparse")
    ap.add_argument("--eval-every", type=int, default=2)
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--trace", action="store_true", help="also export a chrome trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    cfg = SimulationConfig(num_vehicles=args.vehicles, epochs=args.epochs,
                           eval_every=args.eval_every,
                           contact_format=args.contact_format)
    ds = data_lib.load_dataset(cfg.dataset, seed=cfg.seed)
    engine.run_with_context(engine.build_context(
        SimulationConfig(num_vehicles=args.vehicles, epochs=1,
                         contact_format=args.contact_format), dataset=ds))   # warm-up
    # 1. un-profiled: wall time per epoch and the per-phase CUDA-event split
    timer = PhaseTimer(cfg.device)
    ctx = engine.build_context(cfg, dataset=ds, timer=timer)
    kl_kernel.reset_launch_counts()
    kl_solver.reset_solve_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run_with_context(ctx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    p1_route = {"eg_solve_launches": kl_kernel.launch_counts["eg_solve"],
                **{f"{route}_solves": n for route, n in kl_solver.solve_counts.items()}}
    per_epoch = {n: v / cfg.epochs for n, v in sorted(timer.totals_ms().items())}
    phases = {n: v for n, v in per_epoch.items() if not n.endswith(".host")}
    host = {n[:-len(".host")]: v for n, v in per_epoch.items() if n.endswith(".host")}

    # 2. the same run under the profiler: device time by kernel (a kernel's
    # duration does not depend on the profiler; the host's pace does, so the
    # busy share divides the kernels' time by the un-profiled wall time)
    from torch.profiler import ProfilerActivity, profile
    ctx = engine.build_context(cfg, dataset=ds)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.run_with_context(ctx)
        torch.cuda.synchronize()
    events = prof.key_averages()
    # rows of device type CUDA are the kernels and memcpys themselves; the
    # operator rows repeat their time
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in on_device)
    launches = sum(e.count for e in on_device)
    table = events.table(sort_by="self_device_time_total", row_limit=30,
                         max_name_column_width=70)
    summary = {"card": card, "epochs": cfg.epochs, "contact_format": cfg.contact_format,
               "vehicles": cfg.num_vehicles, "eval_every": cfg.eval_every,
               "wall_ms_per_epoch": wall / cfg.epochs * 1e3,
               "phase_device_ms_per_epoch": phases,
               "phase_host_ms_per_epoch": host,
               "p1_route": p1_route,
               "kernel_device_ms_per_epoch": device_us / 1e3 / cfg.epochs,
               "kernel_launches_per_epoch": launches / cfg.epochs,
               "device_busy_share": device_us / 1e6 / wall}
    print(json.dumps(summary), flush=True)
    print(table, flush=True)
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    (out / "kernels.txt").write_text(table)
    if args.trace:
        prof.export_chrome_trace(str(out / "trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
