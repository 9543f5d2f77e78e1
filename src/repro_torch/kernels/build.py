"""Build-at-first-use for the port's CUDA C++ kernels.

Each ``.cu`` source has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers in the sources, so a build takes seconds). Several sources are
compiled in parallel, one ``nvcc`` process each. Libraries are keyed by a
hash of their source and of the ``.cuh`` headers beside it, so an edited
source is never served by a stale build.

The output directory is ``$REPRO_TORCH_BUILD_DIR`` when set, else
``build/repro_torch_kernels/`` beside ``src/`` (ignored by git). Nothing here
runs at import time: modules call ``load_libraries`` inside the function that
launches a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # .../src/repro_torch/kernels/build.py -> the directory holding src/
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of repro_torch are compiled at first use and need the CUDA "
        "toolkit")


def _library_path(source: Path) -> Path:
    # the headers beside a source are part of what it compiles from
    headers = b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha256(
        source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"{source.stem}-{digest}.so"


def load_libraries(sources: list[Path]) -> list[ctypes.CDLL]:
    """Compile (in parallel, where not built yet) and load one shared library
    per source. Raises ``RuntimeError`` with the compiler's output when a
    build fails."""
    targets = [_library_path(Path(s)) for s in sources]
    procs = []
    for source, target in zip(sources, targets):
        if str(target) in _LOADED or target.exists():
            continue
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        procs.append((source, target, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for source, target, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{log}")
            continue
        target.with_suffix(".log").write_text(log)   # ptxas -v resource usage
        os.replace(tmp, target)                      # atomic: no half-written .so
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    libs = []
    for target in targets:
        key = str(target)
        if key not in _LOADED:
            _LOADED[key] = ctypes.CDLL(key)
        libs.append(_LOADED[key])
    return libs


def build_log(source: Path) -> str:
    """What ``nvcc -Xptxas -v`` printed for ``source`` (registers, shared
    memory, spills); empty until the source has been built."""
    log = _library_path(Path(source)).with_suffix(".log")
    return log.read_text() if log.exists() else ""
