#!/usr/bin/env python3
"""Where the serving path spends its time on the GPU (the PyTorch/CUDA port).

    python3 scripts/torch_profile_serve.py [--arch qwen3-1.7b] [--batch 4]
        [--prompt-len 2048] [--steps 8] [--out profile_out] [--trace]
    python3 scripts/torch_profile_serve.py --device cpu --reduced   # a rehearsal

Builds the model at full width (random f32 weights from ``--seed``), warms up,
then times one prefill through the flash-attention kernel and ``--steps``
greedy decode steps without the profiler (host clock around synchronised
work), and once more under ``torch.profiler``: operations by device time,
device events per prefill and per decode step, and the device-busy share of
each (kernel time over the un-profiled wall time). Writes the tables and a
summary under ``--out`` (``--trace``: and chrome traces).
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

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import make_attn_impl  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.precision import full_f32_matmul  # noqa: E402


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _wall(fn, device) -> float:
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


def _profile(fn, device, trace: Path | None):
    """(device µs, device events, table by device time, table by host time)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        fn()
        _sync(device)
    events = prof.key_averages()
    # rows of device type CUDA are the kernels and copies themselves
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    by_device = events.table(sort_by="self_device_time_total" if on_device
                             else "self_cpu_time_total", row_limit=25,
                             max_name_column_width=70)
    by_host = events.table(sort_by="self_cpu_time_total", row_limit=15,
                           max_name_column_width=70)
    if trace is not None:
        prof.export_chrome_trace(str(trace))
    return (sum(e.self_device_time_total for e in on_device),
            sum(e.count for e in on_device), by_device, by_host)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--trace", action="store_true", help="also export chrome traces")
    args = ap.parse_args()
    device = serve.resolve_device(args.device)
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = transformer.init_params(gen, cfg, device=device)
    b, s, steps = args.batch, args.prompt_len, args.steps
    tokens = torch.randint(0, cfg.true_vocab_size, (b, s), generator=gen, device=device)
    impl = make_attn_impl()

    def prefill():
        return transformer.prefill(params, tokens, cfg, attn_impl=impl,
                                   cache_dtype=torch.float32)

    with torch.no_grad(), full_f32_matmul():
        serve.generate(params, tokens[:1, :64], cfg, gen=2, attn_impl=impl)   # warm-up
        logits, state = prefill()
        state = serve.pad_cache(state, cfg, b, s + 3 * steps + 1)
        cur = torch.argmax(logits, dim=-1)[:, None]

        def decode():
            nonlocal cur, state
            for _ in range(steps):
                lg, state = transformer.decode_step(params, cur, state, cfg)
                cur = torch.argmax(lg, dim=-1)[:, None]

        decode()                                                            # warm-up
        prefill_s = _wall(prefill, device)
        decode_s = _wall(decode, device)
        trace = (lambda name: out / f"trace_{name}.json") if args.trace else (lambda name: None)
        pre_us, pre_events, pre_table, pre_host = _profile(prefill, device, trace("prefill"))
        dec_us, dec_events, dec_table, dec_host = _profile(decode, device, trace("decode"))

    on_card = device.type == "cuda"   # off the card there is no device metric to report
    summary = {
        "card": card, "arch": cfg.name, "batch": b, "prompt": s, "decode_steps": steps,
        "prefill_wall_s": prefill_s, "decode_wall_ms_per_step": decode_s / steps * 1e3,
        "prefill_device_ms": pre_us / 1e3 if on_card else None,
        "prefill_device_events": pre_events if on_card else None,
        "prefill_device_busy_share": pre_us / 1e6 / prefill_s if on_card else None,
        "decode_device_ms_per_step": dec_us / 1e3 / steps if on_card else None,
        "decode_device_events_per_step": dec_events / steps if on_card else None,
        "decode_device_busy_share": dec_us / 1e6 / decode_s if on_card else None,
        "decode_host_us_per_device_event": decode_s * 1e6 / dec_events if on_card else None,
    }
    print(json.dumps(summary), flush=True)
    for name, table in (("prefill_by_device", pre_table), ("decode_by_device", dec_table),
                        ("decode_by_host", dec_host), ("prefill_by_host", pre_host)):
        print(f"--- {name}\n{table}", flush=True)
        (out / f"{name}.txt").write_text(table)
    (out / "serve_summary.json").write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
