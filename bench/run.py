#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``bench/`` and the
port (``src/repro_torch``). Without a CUDA device, or with fewer than the cell
asks for, it exits 2 and prints no result. Everything the cell needs is found
by name: ``BENCHMARK.json`` names the cell's configuration and traffic,
``bench/workloads/<cell>.json`` its driver, traffic, traced calls and limits,
``bench/configs/<config>.json`` the configuration, ``bench/drivers/<driver>.py``
the set-up and the call the window repeats, ``bench/metrics/<metric>.py`` each
per-layer metric's reader (see ``bench/lib/harness.py``).
"""
import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
# every build and kernel cache of the program inside the checkout, at fixed paths
os.environ["REPRO_TORCH_BUILD_DIR"] = str(BUILD / "repro_torch_kernels")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(BUILD / "inductor")
os.environ.setdefault("OMP_NUM_THREADS", "4")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], START))
