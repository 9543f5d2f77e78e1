#!/usr/bin/env python3
"""Where one step of the one-launch P1 solve (``eg_solve``) spends its cycles.

    python3 scripts/torch_profile_eg_solve.py [--k 8 100 234] [--steps 200]
                                              [--stream-k 100] [--stream-seed 0]

Needs one CUDA device and ``nvcc``. Builds a copy of
``kernels/kl_simplex/csrc/eg_solve.cu`` with a ``clock64()`` mark before each
of the four block barriers of its step loop and after the last (thread 0 of
block 0 keeps the sums), and prints the cycles per step of each phase as
thread 0 sees them: ``u`` (its warp's share of the u product), ``log_u`` (the
wait for the other warps' u, then log u), ``grad`` (the wait, then its share
of the grad product), ``update`` (the wait, then warp 0's EG update of the
row) and ``last_barrier``. Beside them: the uninstrumented kernel's time per
solve (CUDA events, all rows) and per step, and the SM clock it implies.

Two layouts of the one wrapper ``eg_solve_rows``, one line each: dense
contacts (no id table: a seeded ``[K, K]`` problem with a row of alpha per K,
for each ``--k``) and the neighbour lists ``core.kl_solver.solve_p1_all``
passes as ids (``--stream-k`` vehicles, the ids and mask of epoch 0 of a
real contact stream at the paper's settings over 50 epochs, D = its D_max);
the dense lines include ``--stream-k``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.kernels import build as build_lib  # noqa: E402
from repro_torch.kernels.kl_simplex import kernel  # noqa: E402

PHASES = ["u", "log_u", "grad", "update", "last_barrier"]


def instrumented_source(out_dir: Path) -> Path:
    """eg_solve.cu with the phase marks, and its headers, under ``out_dir``."""
    src_dir = kernel.SOURCES["eg_solve"].parent
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in src_dir.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    src = kernel.SOURCES["eg_solve"].read_text()
    src, n = re.subn(r"int num_steps, float step\) \{\n",
                     "int num_steps, float step, long long* prof) {\n"
                     "  long long ph[5] = {0, 0, 0, 0, 0};\n"
                     "  long long t_prev = 0;\n"
                     "  const bool rec = blockIdx.x == 0 && threadIdx.x == 0;\n"
                     "#define MARK(i) if (rec) { const long long t_now = clock64(); "
                     "ph[i] += t_now - t_prev; t_prev = t_now; }\n", src, count=1)
    loop = src.index("for (int t = 0; t < num_steps; ++t) {")
    head, body = src[:loop], src[loop:]
    body = body.replace("for (int t = 0; t < num_steps; ++t) {",
                        "if (rec) t_prev = clock64();\n  for (int t = 0; t < num_steps; ++t) {", 1)
    parts = body.split("__syncthreads();")
    if n != 1 or len(parts) < 5:
        raise SystemExit("eg_solve.cu does not have the expected step loop")
    body = "".join(f"{p}MARK({i})\n    __syncthreads();" for i, p in enumerate(parts[:4]))
    body += "\n    MARK(4)" + "__syncthreads();".join(parts[4:])
    src = head + body
    src = src.replace("  if (warp == 0) {\n    float* o_row = out + row * d;",
                      "  if (rec) for (int i = 0; i < 5; ++i) prof[i] = ph[i];\n"
                      "  if (warp == 0) {\n    float* o_row = out + row * d;", 1)
    src = src.replace("num_steps, step);\n  return cudaGetLastError();",
                      "num_steps, step, g_prof);\n  return cudaGetLastError();", 1)
    src = src.replace("template <int ITEMS, bool kRows>\ncudaError_t launch(",
                      "long long* g_prof = nullptr;\n\ntemplate <int ITEMS, bool kRows>\n"
                      "cudaError_t launch(", 1)
    src = src.replace('extern "C" int eg_solve_rows_launch(',
                      'extern "C" void eg_solve_set_prof(long long* p) { g_prof = p; }\n\n'
                      'extern "C" int eg_solve_rows_launch(', 1)
    if src.count("MARK(") != 6 or "g_prof);" not in src or "eg_solve_set_prof" not in src:
        raise SystemExit("could not place the phase marks in eg_solve.cu")
    path = out_dir / "eg_solve.cu"
    path.write_text(src)
    return path


def p1_case(k: int, seed: int):
    r = np.random.default_rng(seed)
    s = r.dirichlet(np.ones(k), size=k).astype(np.float32)
    g = r.dirichlet(np.ones(k) * 2).astype(np.float32)
    c = np.minimum((r.random((k, k)) < 0.1) + (r.random((k, k)) < 0.1).T + np.eye(k), 1)
    return (torch.as_tensor(s).cuda(), torch.as_tensor(g).cuda(),
            torch.as_tensor(c.astype(np.float32)).cuda())


def time_ms(fn, reps: int = 7) -> float:
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def stream_case(k: int, seed: int):
    """States, target and the neighbour lists of epoch 0 of a real contact
    stream (the paper's settings, ``k`` vehicles, 50 epochs): ids, mask
    ``[k, D_max]``."""
    from repro_torch.fed import engine, topology
    cfg = engine.SimulationConfig(num_vehicles=k, epochs=50, device="cpu", seed=seed)
    window = engine.ContactStream(cfg, topology.make_road_network(cfg.road_net,
                                                                  seed=cfg.seed)).window(1)
    s, g, _ = p1_case(k, k)
    return (s, g, torch.as_tensor(window.idx[0]).cuda(),
            torch.as_tensor(window.mask[0]).cuda())


def phase_line(form: str, k: int, d: int, steps: int, prof: torch.Tensor, ms: float) -> dict:
    cycles = {name: v / steps for name, v in zip(PHASES, prof.cpu().tolist())}
    step_cycles = sum(cycles.values())
    return {"form": form, "K": k, "D": d, "steps": steps, "cycles_per_step": cycles,
            "cycles_per_step_total": step_cycles, "solve_ms": ms,
            "us_per_step": ms * 1e3 / steps,
            "implied_sm_clock_ghz": step_cycles * steps / (ms * 1e6)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, nargs="+", default=[8, 100, 234])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--stream-k", type=int, default=100)
    ap.add_argument("--stream-seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    source = instrumented_source(build_lib.build_dir() / "eg_solve_phases")
    lib, = build_lib.load_libraries([source])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.eg_solve_rows_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                                         ctypes.c_float, ptr]
    lib.eg_solve_rows_launch.restype = i32
    lib.eg_solve_set_prof.argtypes = [ptr]
    prof = torch.zeros(5, dtype=torch.int64, device="cuda")
    lib.eg_solve_set_prof(prof.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream

    def dense(k, s, g, c):
        one = c[:1].contiguous()
        out = torch.empty(1, k, device="cuda")
        code = lib.eg_solve_rows_launch(s.data_ptr(), None, g.data_ptr(), one.data_ptr(),
                                        out.data_ptr(), 1, 1, k, k, k, args.steps, 2.0, stream)
        if code != 0:
            raise SystemExit(f"FAILED: the instrumented launch returned {code}")
        torch.cuda.synchronize()
        ms = time_ms(lambda: kernel.eg_solve_rows(s, None, g, c, num_steps=args.steps))
        return phase_line("dense", k, k, args.steps, prof, ms)

    for k in sorted(set(args.k) | {args.stream_k}):
        print(json.dumps(dense(k, *p1_case(k, k))), flush=True)
    # the id-table form on a real contact stream's neighbour lists, beside the
    # dense form on the same states
    k = args.stream_k
    s, g, ids, mask = stream_case(k, args.stream_seed)
    d = ids.shape[1]
    out = torch.empty(1, d, device="cuda")
    code = lib.eg_solve_rows_launch(s.data_ptr(), ids.data_ptr(), g.data_ptr(), mask.data_ptr(),
                                    out.data_ptr(), 1, 1, k, d, k, args.steps, 2.0, stream)
    if code != 0:
        raise SystemExit(f"FAILED: the instrumented id-table launch returned {code}")
    torch.cuda.synchronize()
    ms = time_ms(lambda: kernel.eg_solve_rows(s, ids, g, mask, num_steps=args.steps))
    print(json.dumps({**phase_line("id_table", k, d, args.steps, prof, ms),
                      "stream_seed": args.stream_seed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
