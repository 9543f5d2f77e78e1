#!/usr/bin/env python3
"""Build variants of one family of the port's CUDA kernels and time them side
by side, in one process on one card (kernel times move between calls, so
compare builds only within one run).

    python3 scripts/torch_kernel_variants.py grouped '{"x": {"grouped_mm.cu": [["old", "new"]]}}'
    python3 scripts/torch_kernel_variants.py rows VARIANTS.json [--parent DIR]
                                             [--sass DIR] [--out FILE]

(``scripts/row_kernel_variants.json`` holds the row kernels' variants and
probes: no programmatic launch, other mappings, an empty body, g read as a
constant, no ``log2f`` in the staging, no dot with the staged values.)

A family is a kernel package, the libraries of it that each build replaces,
the cases a build is checked at against the plain versions (at
``chip_smoke.py``'s tolerances) and the cases it is timed at
(``chip_smoke.py``'s shapes):

* ``grouped``: ``grouped_mm.cu`` (``grouped_mm``, its transpose and
  ``grouped_mm_wgrad``), checked at ragged shapes in f32 and bf16, timed at
  granite-moe's and mixtral's prefill and granite's decode step;
* ``rows``: ``kl_rows.cu`` and ``entropy_rows.cu`` of ``kl_simplex``,
  checked at ``chip_smoke.py``'s edge cases and the timed shapes, timed at
  V = K = 100, V = K = 1,024 (f32, bf16), V = 64 x K = 4,096 and V = 1,
  K = 32.

The builds: ``this`` (the package's sources), ``parent`` (``--parent DIR``:
the same sources of another commit's checkout) and each variant (JSON, or a
.json file: name -> {file in the package's csrc: [[old, new], ...]}, text
substitutions on a copy of this tree's csrc, every ``old`` must occur;
``"unchecked": true`` marks a probe that computes something else on purpose,
timed only). All are compiled at once, one ``nvcc`` each with the package's
flags; each is then bound in place of the package's library, with its
argument types, and driven through the package's wrappers. Each timed case
runs through the builds forward, then backward (``chip_smoke.time_ms``: CUDA
events, median), and keeps the better of the two times per build.

Prints the card, each build's ptxas register counts, one JSON line per build
with what disagreed and one per timed case; ``--out`` writes the JSON lines
too, ``--sass`` each build's SASS (gzipped) into DIR. With ``--parent``, the
package's sources that include the family's headers without being part of it
(``rows``: ``eg_step.cu``, ``eg_solve.cu``) are also compared SASS to SASS
between the two trees. Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import gzip
import json
import re
import shutil
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import build as build_lib  # noqa: E402
from repro_torch.kernels import kl_simplex  # noqa: E402
from repro_torch.kernels.grouped_mm import grouped_mm_ref, grouped_mm_wgrad_ref  # noqa: E402
from repro_torch.kernels.grouped_mm import kernel as gk  # noqa: E402
from repro_torch.precision import full_f32_matmul  # noqa: E402

OUT = ROOT / "build" / "kernel_variants"


@dataclass
class Family:
    module: ModuleType                    # its build() and _LIBS
    libs: dict[str, str]                  # key of module._LIBS -> source in csrc
    check: Callable[[], list]             # what disagrees with the plain versions
    timed: Callable[[], dict]             # label -> (fn, time_ms keywords)
    same_sass: tuple[str, ...] = ()       # sources that share its headers

    @property
    def csrc(self) -> Path:
        return Path(self.module.__file__).resolve().parent / "csrc"


# --- grouped: grouped_mm.cu ---------------------------------------------------

# (M, K, N, group sizes): ragged widths, a group ending inside a tile, decode
GROUPED_CHECKS = [(300, 128, 256, [100, 0, 200]), (130, 70, 33, [0, 64, 1, 0, 65]),
                  (16, 1024, 512, [2, 0, 3, 1, 10]), (700, 72, 136, [350, 0, 350])]
GROUPED_TIMED = [("granite", *smoke.RAGGED_SHAPES[0][1:]),
                 ("mixtral", *smoke.RAGGED_SHAPES[1][1:]),
                 ("decode", *smoke.RAGGED_DECODE_SHAPE[1:])]


def _products(x, w, dy, offsets):
    return {"fwd": (lambda: gk.grouped_mm(x, w, offsets), lambda: grouped_mm_ref(x, w, offsets)),
            "trans": (lambda: gk.grouped_mm(dy, w, offsets, True),
                      lambda: grouped_mm_ref(dy, w, offsets, True)),
            "wgrad": (lambda: gk.grouped_mm_wgrad(x, dy, offsets),
                      lambda: grouped_mm_wgrad_ref(x, dy, offsets))}


def _grouped_check() -> list:
    bad = []
    for m, k, n, sizes in GROUPED_CHECKS:
        r = np.random.default_rng(0)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.as_tensor(r.normal(size=(m, k)).astype(np.float32) / np.sqrt(k))
            w = torch.as_tensor(r.normal(size=(len(sizes), k, n)).astype(np.float32))
            dy = torch.as_tensor(r.normal(size=(m, n)).astype(np.float32))
            x, w, dy = (t.to(dtype).to("cuda") for t in (x, w, dy))
            offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32),
                                      device="cuda")
            with full_f32_matmul():
                for what, (fn, plain) in _products(x, w, dy, offsets).items():
                    err, ok = smoke._grouped_agrees(fn(), plain(), dtype)
                    if not ok:
                        bad.append([what, str(dtype), m, k, n, err])
    return bad


def _grouped_timed() -> dict:
    cases = {}
    for label, m, e, d, f in GROUPED_TIMED:
        kw = {} if label == "decode" else dict(inner=2, reps=5, warm=2)
        for dtype in (torch.float32, torch.bfloat16):
            x, w, dy, offsets, _ = smoke._grouped_inputs(m, e, d, f, dtype, m + e, "cuda")
            for what, (fn, _) in _products(x, w, dy, offsets).items():
                cases[f"{what} {label} {str(dtype)[6:]}"] = (fn, kw)
    return cases


# --- rows: kl_rows.cu, entropy_rows.cu ----------------------------------------

ROW_SHAPES = [(100, 100, torch.float32), (1024, 1024, torch.float32),
              (1024, 1024, torch.bfloat16), (64, 4096, torch.float32), (1, 32, torch.float32)]


def _row_fns(s, g) -> dict:
    return {"kl_rows": (lambda: kl_simplex.kl_rows_kernel(s, g),
                        lambda: kl_simplex.kl_rows_ref(s, g)),
            "entropy_rows": (lambda: kl_simplex.entropy_rows_kernel(s),
                             lambda: kl_simplex.entropy_rows_ref(s))}


def _rows_check() -> list:
    cases = [(f"[{v},{k}] {dtype}", *smoke._state_case(v, k, dtype, v + k, "cuda"), dtype)
             for v, k, dtype in ROW_SHAPES]
    bad = []
    for what, s, g, dtype in cases + smoke._row_edge_cases("cuda"):
        for name, (fn, plain) in _row_fns(s, g).items():
            err = smoke._max_err(fn(), plain())
            if not err <= smoke.ATOL[dtype]:
                bad.append([name, what, err])
    return bad


def _rows_timed() -> dict:
    cases = {}
    for v, k, dtype in ROW_SHAPES:
        s, g = smoke._state_case(v, k, dtype, v + k, "cuda")
        for name, (fn, _) in _row_fns(s, g).items():
            cases[f"{name} [{v},{k}] {str(dtype)[6:]}"] = (fn, {})
    return cases


FAMILIES = {
    "grouped": Family(gk, {"grouped_mm": "grouped_mm.cu"}, _grouped_check, _grouped_timed),
    "rows": Family(kl_simplex.kernel, {"kl_rows": "kl_rows.cu", "entropy_rows": "entropy_rows.cu"},
                   _rows_check, _rows_timed, same_sass=("eg_step.cu", "eg_solve.cu")),
}


# --- the harness --------------------------------------------------------------

def _copy_csrc(family: Family, name: str, tree: Path, subs: dict) -> Path:
    """A copy of ``tree``'s csrc of the family with ``subs`` applied."""
    out = _copy_dir(family, name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(tree / family.csrc.relative_to(ROOT), out)
    for file, pairs in subs.items():
        if file == "unchecked":
            continue
        text = (out / file).read_text()
        for old, new in pairs:
            if old not in text:
                raise SystemExit(f"{name}: substitution not found in {file}: {old!r}")
            text = text.replace(old, new)
        (out / file).write_text(text)
    return out


def _copy_dir(family: Family, name: str) -> Path:
    return OUT / family.csrc.parent.name / name


def _declared_like(lib: ctypes.CDLL, package: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument and result types the package gave its own
    library's functions."""
    for fname, fn in vars(package).items():
        if isinstance(fn, ctypes._CFuncPtr):
            mine = getattr(lib, fname)
            mine.argtypes, mine.restype = fn.argtypes, fn.restype
    return lib


def _sass(library: Path) -> list[str]:
    """The functions and instructions of a built library's SASS. A function in
    an anonymous namespace is named after a hash of its file's path, which
    differs between two trees: the hash is left out."""
    dump = subprocess.run(["cuobjdump", "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    return [re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", line.strip())
            for line in dump.splitlines() if "Function :" in line or "/*0" in line]


def builds(family: Family, parent: Path | None, variants: dict,
           sass: Path | None) -> dict:
    """build name -> {key of module._LIBS: library}, ``this`` the package's."""
    family.module.build()
    package = {key: family.module._LIBS[key] for key in family.libs}
    trees = {}
    if parent is not None:
        trees["parent"] = _copy_csrc(family, "parent", parent, {})
    for name, subs in variants.items():
        trees[name] = _copy_csrc(family, name, ROOT, subs)
    sources = [trees[b] / src for b in trees for src in family.libs.values()]
    loaded = iter(build_lib.load_libraries(sources))       # all at once, one nvcc each
    out = {"this": package}
    for b in trees:
        out[b] = {key: _declared_like(next(loaded), package[key]) for key in family.libs}
    for b in out:
        csrc = family.csrc if b == "this" else trees[b]
        for key, src in family.libs.items():
            log = build_lib.build_log(csrc / src)
            regs = sorted({line.split("Used ")[1].split(",")[0]
                           for line in log.splitlines() if "Used " in line})
            print(f"{b} {src}: {regs}", flush=True)
            if sass is not None:
                dump = subprocess.run(["cuobjdump", "-sass",
                                       str(build_lib._library_path(csrc / src))],
                                      capture_output=True, text=True)
                sass.mkdir(parents=True, exist_ok=True)
                with gzip.open(sass / f"{b}-{Path(src).stem}.sass.gz", "wt") as f:
                    f.write(dump.stdout)
    return out


def same_sass(family: Family, parent: Path) -> dict:
    """source -> whether this tree's and the parent's compile to the same SASS."""
    theirs = _copy_dir(family, "parent")
    ours = [family.csrc / n for n in family.same_sass]
    other = [theirs / n for n in family.same_sass]
    build_lib.load_libraries(ours + other)
    return {n: _sass(build_lib._library_path(a)) == _sass(build_lib._library_path(b))
            for n, a, b in zip(family.same_sass, ours, other)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("family", choices=sorted(FAMILIES))
    parser.add_argument("variants", nargs="?", default="{}",
                        help="JSON (or a .json file): name -> {file: [[old, new], ...]}")
    parser.add_argument("--parent", type=Path, help="root of another commit's checkout")
    parser.add_argument("--sass", type=Path, default=None)
    parser.add_argument("--out", type=Path, help="also write the JSON lines here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 1
    family = FAMILIES[args.family]
    spec = args.variants
    variants = json.loads(Path(spec).read_text() if spec.endswith(".json") else spec)
    print(smoke.nvidia_smi_line(), flush=True)
    libs = builds(family, args.parent.resolve() if args.parent else None, variants, args.sass)
    lines = []

    def emit(rec: dict) -> None:
        print(json.dumps(rec), flush=True)
        lines.append(json.dumps(rec))

    if args.parent and family.same_sass:
        emit({"same_sass_as_parent": same_sass(family, args.parent.resolve())})
    package = libs["this"]
    for b, lib in libs.items():
        family.module._LIBS.update(lib)
        disagrees = family.check()
        emit({"build": b, "disagrees": disagrees})
        if disagrees and not variants.get(b, {}).get("unchecked"):
            raise SystemExit(f"{b}: disagrees with the plain versions")
    order = list(libs) + list(libs)[::-1]
    for label, (fn, kw) in family.timed().items():
        turns = {b: [] for b in libs}
        for b in order:
            family.module._LIBS.update(libs[b])
            turns[b].append(smoke.time_ms(fn, **kw))
        emit({"case": label, "ms": {b: min(t) for b, t in turns.items()}, "turns_ms": turns})
    family.module._LIBS.update(package)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
