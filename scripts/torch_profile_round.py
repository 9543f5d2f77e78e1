#!/usr/bin/env python3
"""Where a DFL-DDS round spends its time on the GPU (the PyTorch/CUDA port).

    python3 scripts/torch_profile_round.py [--epochs 2] [--contact-format sparse]
                                           [--vehicles 100] [--out profile_out]
    python3 scripts/torch_profile_round.py --arch granite-moe-1b-a400m [--seq-len 4096]
        [--batch 1] [--vehicles 2] [--variant opt_ragged] [--layers L] [--held-experts N]

Runs ``run_simulation`` at the paper's MNIST configuration for one warm-up
epoch, then ``--epochs`` epochs un-profiled (wall time per epoch, per-phase
CUDA-event split from ``repro_torch.profiling``, the P1 solve's route: its
``eg_solve`` launches and ``core.kl_solver.solve_counts``) and once more under
``torch.profiler`` (kernels by total device time, launches per epoch, the
device-busy share). Writes the table under ``--out`` (``--trace``: and a
chrome trace).

With ``--arch``, the same for DFL-DDS train rounds of that architecture at
full width (``launch.steps.build_dds_train_step`` under ``--variant``; one
warm-up round, then ``--epochs`` rounds), the train step's attention route
printed beside P1's: the training kernels' launches (``flash_train_fwd``:
forward and remat's recompute, 2 L V a round under bf16 compute;
``flash_train_dq`` / ``flash_train_dkdv``: L V each; 0 in f32, which attends
through ``_sdpa``) and AdamW's (``adamw``: ceil(leaves / 64) a vehicle step,
V of them a round for the configs here). ``--layers`` cuts the depth,
``--held-experts`` holds the first N routed experts of a deepseek_v3 config
(``expert_range``).
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
from repro_torch.kernels.adamw import kernel as adamw_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.data import datasets as data_lib  # noqa: E402
from repro_torch.fed import engine  # noqa: E402
from repro_torch.fed.simulator import SimulationConfig  # noqa: E402
from repro_torch.kernels.kl_simplex import kernel as kl_kernel  # noqa: E402
from repro_torch.profiling import PhaseTimer  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--vehicles", type=int,
                    help="K of the federation (100), V of the train rounds (2)")
    ap.add_argument("--contact-format", default="sparse")
    ap.add_argument("--eval-every", type=int, default=2)
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--trace", action="store_true", help="also export a chrome trace")
    ap.add_argument("--arch", help="profile DDS train rounds of this architecture instead")
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--variant", default="opt_ragged")
    ap.add_argument("--layers", type=int, help="cut the architecture to this many layers")
    ap.add_argument("--held-experts", type=int, help="hold the first N routed experts")
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
    if args.arch:
        return profile_train(args, card, out)
    args.vehicles = args.vehicles or 100

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
    _reset_routes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run_with_context(ctx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    p1_route = _routes()
    per_epoch = {n: v / cfg.epochs for n, v in sorted(timer.totals_ms().items())}
    phases = {n: v for n, v in per_epoch.items() if not n.endswith(".host")}
    host = {n[:-len(".host")]: v for n, v in per_epoch.items() if n.endswith(".host")}

    # 2. the same run under the profiler: device time by kernel (a kernel's
    # duration does not depend on the profiler; the host's pace does, so the
    # busy share divides the kernels' time by the un-profiled wall time)
    ctx = engine.build_context(cfg, dataset=ds)
    device_us, launches, table, prof = _profiled(lambda: engine.run_with_context(ctx))
    summary = {"card": card, "epochs": cfg.epochs, "contact_format": cfg.contact_format,
               "vehicles": cfg.num_vehicles, "eval_every": cfg.eval_every,
               "wall_ms_per_epoch": wall / cfg.epochs * 1e3,
               "phase_device_ms_per_epoch": phases,
               "phase_host_ms_per_epoch": host,
               "p1_route": p1_route,
               "kernel_device_ms_per_epoch": device_us / 1e3 / cfg.epochs,
               "kernel_launches_per_epoch": launches / cfg.epochs,
               "device_busy_share": device_us / 1e6 / wall}
    return _write(summary, table, prof, out, args.trace)


def _routes() -> dict:
    """The route counters since the last reset: P1's ``eg_solve`` launches
    and solves by route, the training attention's launches, AdamW's."""
    return {"eg_solve_launches": kl_kernel.launch_counts["eg_solve"],
            **{f"{route}_solves": n for route, n in kl_solver.solve_counts.items()},
            **{f"{name}_launches": fa_kernel.launch_counts[name]
               for name in ("flash_train_fwd", "flash_train_dq", "flash_train_dkdv")},
            "adamw_launches": adamw_kernel.launch_counts["adamw"]}


def _reset_routes() -> None:
    kl_kernel.reset_launch_counts()
    kl_solver.reset_solve_counts()
    fa_kernel.reset_launch_counts()
    adamw_kernel.reset_launch_counts()


def _profiled(run):
    """``run()`` under ``torch.profiler``: (device us, device launches, the
    kernel table, the profile)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # rows of device type CUDA are the kernels and memcpys themselves; the
    # operator rows repeat their time
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    table = events.table(sort_by="self_device_time_total", row_limit=30,
                         max_name_column_width=70)
    return (sum(e.self_device_time_total for e in on_device),
            sum(e.count for e in on_device), table, prof)


def _write(summary: dict, table: str, prof, out: Path, trace: bool) -> int:
    print(json.dumps(summary), flush=True)
    print(table, flush=True)
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    (out / "kernels.txt").write_text(table)
    if trace:
        prof.export_chrome_trace(str(out / "trace.json"))
    return 0


def profile_train(args, card: str, out: Path) -> int:
    """DDS train rounds of ``args.arch`` (module docstring)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import steps, train, variants

    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.held_experts:
        cfg = dataclasses.replace(cfg, expert_range=(0, args.held_experts))
    v = args.vehicles or 2
    cfg, overrides = variants.apply_variant(args.variant, cfg, "train")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params, opt, sm = steps.init_train_state(cfg, v, gen, device="cuda")
    contact = train.ring_contact(v, "cuda")
    target = torch.full((v,), 1.0 / v, device="cuda")

    def rounds(n, timer=None):
        nonlocal params, opt, sm
        ts = steps.build_dds_train_step(cfg, lr=1e-3, timer=timer, **overrides)
        for _ in range(n):
            tokens = torch.randint(0, cfg.true_vocab_size, (v, args.batch, args.seq_len),
                                   generator=gen, device="cuda")
            params, opt, sm, _ = ts.fn(params, opt, sm, tokens, contact, target)

    rounds(1)                                                   # warm-up
    timer = PhaseTimer("cuda")
    _reset_routes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rounds(args.epochs, timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    routes = _routes()
    per_round = {n: x / args.epochs for n, x in sorted(timer.totals_ms().items())}
    device_us, launches, table, prof = _profiled(lambda: rounds(1))
    summary = {"card": card, "arch": cfg.name, "layers": cfg.num_layers, "vehicles": v,
               "batch": args.batch, "seq_len": args.seq_len, "variant": args.variant,
               "rounds": args.epochs, "wall_ms_per_round": wall / args.epochs * 1e3,
               "phase_device_ms_per_round": {n: x for n, x in per_round.items()
                                             if not n.endswith(".host")},
               "routes_per_round": {n: x / args.epochs for n, x in routes.items()},
               "kernel_device_ms_per_round": device_us / 1e3,
               "kernel_launches_per_round": launches,
               "device_busy_share": device_us / 1e6 / (wall / args.epochs)}
    return _write(summary, table, prof, out, args.trace)


if __name__ == "__main__":
    sys.exit(main())
