"""The torch twins of the examples (``examples/torch_*.py``): each runs with
``--smoke --device cpu`` as a subprocess, as a user would start it (its own
``sys.path`` bootstrap, no ``PYTHONPATH``), on one torch thread, and prints
its reference's summary and an ``... OK`` line; without a card the default
``--device cuda`` raises instead of falling back. ``torch_serve_batched.py``
is held in ``test_torch_zoo.py``."""
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENV = {"PATH": "", "OMP_NUM_THREADS": "1"}


def _run(script, *args):
    return subprocess.run([sys.executable, str(ROOT / "examples" / script), *args],
                          capture_output=True, text=True, cwd=ROOT, env=ENV, timeout=300)


@pytest.mark.parametrize("script,says", [
    ("torch_quickstart.py", ["avg accuracy :", "state-vector entropy (diversity)",
                             "quickstart OK: final average accuracy over 6 vehicles"]),
    ("torch_scenario_sweep.py", ["grid/balanced_noniid/dds", "highway/balanced_noniid/d_fedavg",
                                 "scenario_sweep OK: 4 scenarios x 3 seeds on cpu"]),
    ("torch_multiarch_dfl.py", ["--- qwen3-1.7b (dense)", "--- rwkv6-3b (ssm)",
                                "--- granite-moe-1b-a400m (moe)", "round 0: loss=",
                                "multiarch_dfl OK: 3 architectures x 1 rounds on cpu"]),
    ("torch_vehicular_mnist_e2e.py", ["=== DDS ===", "=== DFL ===", "=== SP ===",
                                      "paper claims on this run:", "DFL-DDS >= DFL   (avg acc):",
                                      "DFL-DDS >= SP    (avg acc):",
                                      "accuracy-diversity Pearson (SP):",
                                      "DDS consensus distance <= DFL:",
                                      "vehicular_mnist_e2e OK: dds / dfl / sp"]),
], ids=lambda v: v if isinstance(v, str) else "")
def test_torch_example_smoke_on_the_cpu(script, says):
    run = _run(script, "--smoke", "--device", "cpu")
    assert run.returncode == 0, run.stderr[-2000:]
    for line in says:
        assert line in run.stdout, (line, run.stdout[-2000:])


def test_torch_example_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    run = _run("torch_quickstart.py", "--smoke")
    assert run.returncode != 0 and "no CUDA device" in run.stderr
    assert "OK" not in run.stdout
