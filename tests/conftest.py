import os
import pathlib
import sys

# single-device CPU for all tests (the dry-run is exercised via subprocess)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# pyproject's pythonpath=["src"] handles the installed/pytest case; keep a
# direct fallback so `python tests/...` and odd invocations also resolve.
_SRC = str(pathlib.Path(__file__).resolve().parent.parent / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

try:
    import hypothesis  # noqa: F401 — the real library, when available
except ModuleNotFoundError:  # offline container: install the bundled shim
    from repro._compat import hypothesis_fallback

    hypothesis_fallback.install()

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped where there is none")
