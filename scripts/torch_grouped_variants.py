#!/usr/bin/env python3
"""Build variants of the grouped-product kernel and time them side by side,
in one process on one card (kernel times move between calls, so compare
variants only within one run).

    python3 scripts/torch_grouped_variants.py '{"as_is": [], "x": [["old", "new"]]}'
    python3 scripts/torch_grouped_variants.py VARIANTS.json [--sass DIR]

Each variant is a list of text substitutions applied to
``src/repro_torch/kernels/grouped_mm/csrc/grouped_mm.cu`` (every ``old`` must
occur in the source; an empty list is the source as it is). All variants are
compiled at once, one ``nvcc`` each with the package's flags, into
``build/grouped_variants/``. Each is then bound in place of the built library
and checked against the plain versions (``grouped_mm``, its transpose and
``grouped_mm_wgrad`` at a few ragged shapes, f32 and bf16, at the tolerances
of ``chip_smoke.py``), and timed at ``chip_smoke.py``'s shapes: granite-moe
and mixtral prefill and granite's decode step (CUDA events, median). Prints
each build's ptxas resource lines and one JSON line per variant; ``--sass``
writes each variant's SASS (gzipped) into DIR. Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import gzip
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import build as build_lib  # noqa: E402
from repro_torch.kernels.grouped_mm import grouped_mm_ref, grouped_mm_wgrad_ref  # noqa: E402
from repro_torch.kernels.grouped_mm import kernel as gk  # noqa: E402
from repro_torch.precision import full_f32_matmul  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/grouped_mm/csrc/grouped_mm.cu"
OUT = ROOT / "build" / "grouped_variants"
# (M, K, N, group sizes): ragged widths, a group ending inside a tile, decode
CHECKS = [(300, 128, 256, [100, 0, 200]), (130, 70, 33, [0, 64, 1, 0, 65]),
          (16, 1024, 512, [2, 0, 3, 1, 10]), (700, 72, 136, [350, 0, 350])]
TIMED = [("granite", *smoke.RAGGED_SHAPES[0][1:]), ("mixtral", *smoke.RAGGED_SHAPES[1][1:]),
         ("decode", *smoke.RAGGED_DECODE_SHAPE[1:])]


def build(variants: dict, sass: Path | None) -> dict:
    """Compiles every variant at once; returns name -> bound library."""
    text = SOURCE.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"{name}: substitution not found in the source: {old!r}")
            src = src.replace(old, new)
        (OUT / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [build_lib.find_nvcc(), *build_lib.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"{name}: {line.strip()}", flush=True)
        if proc.returncode != 0:
            print(log)
            raise SystemExit(f"{name}: nvcc failed")
        if sass is not None:
            dump = subprocess.run(["cuobjdump", "-sass", str(OUT / f"{name}.so")],
                                  capture_output=True, text=True)
            sass.mkdir(parents=True, exist_ok=True)
            with gzip.open(sass / f"{name}.sass.gz", "wt") as f:
                f.write(dump.stdout)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.grouped_mm_launch.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        lib.grouped_mm_launch.restype = i32
        lib.grouped_mm_wgrad_launch.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
        lib.grouped_mm_wgrad_launch.restype = i32
        lib.grouped_mm_grid.argtypes = [i32] * 6
        lib.grouped_mm_grid.restype = ctypes.c_longlong
        lib.grouped_mm_error_string.argtypes = [i32]
        lib.grouped_mm_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def _products(x, w, dy, offsets):
    return {"fwd": (lambda: gk.grouped_mm(x, w, offsets), lambda: grouped_mm_ref(x, w, offsets)),
            "trans": (lambda: gk.grouped_mm(dy, w, offsets, True),
                      lambda: grouped_mm_ref(dy, w, offsets, True)),
            "wgrad": (lambda: gk.grouped_mm_wgrad(x, dy, offsets),
                      lambda: grouped_mm_wgrad_ref(x, dy, offsets))}


def check(device) -> list:
    """The products against their plain versions; returns what disagreed."""
    bad = []
    for m, k, n, sizes in CHECKS:
        r = np.random.default_rng(0)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.as_tensor(r.normal(size=(m, k)).astype(np.float32) / np.sqrt(k))
            w = torch.as_tensor(r.normal(size=(len(sizes), k, n)).astype(np.float32))
            dy = torch.as_tensor(r.normal(size=(m, n)).astype(np.float32))
            x, w, dy = (t.to(dtype).to(device) for t in (x, w, dy))
            offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32),
                                      device=device)
            with full_f32_matmul():
                for what, (fn, plain) in _products(x, w, dy, offsets).items():
                    err, ok = smoke._grouped_agrees(fn(), plain(), dtype)
                    if not ok:
                        bad.append([what, str(dtype), m, k, n, err])
    return bad


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", help="JSON (or a .json file): name -> [[old, new], ...]")
    parser.add_argument("--sass", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 1
    spec = args.variants
    variants = json.loads(Path(spec).read_text() if spec.endswith(".json") else spec)
    print(smoke.nvidia_smi_line(), flush=True)
    libs = build(variants, args.sass)
    inputs = {(label, dtype): smoke._grouped_inputs(m, e, d, f, dtype, m + e, "cuda")
              for label, m, e, d, f in TIMED for dtype in (torch.float32, torch.bfloat16)}
    for name, lib in libs.items():
        gk._LIBS["grouped_mm"] = lib
        row = {"variant": name, "disagrees": check("cuda"), "ms": {}}
        for (label, dtype), (x, w, dy, offsets, _) in inputs.items():
            time_kw = {} if label == "decode" else dict(inner=2, reps=5, warm=2)
            with full_f32_matmul():
                for what, (fn, _) in _products(x, w, dy, offsets).items():
                    row["ms"][f"{what} {label} {str(dtype)[6:]}"] = smoke.time_ms(fn, **time_kw)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
