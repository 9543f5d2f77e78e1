"""The controls of the comparison that decides ``correct``, at the cells'
own sizes on the card (run there with ``python -m pytest -q -s -m cuda
bench/test_bench_control.py``; skipped without a card).

Each puts the reference, computed one precision below the configuration's,
in the program's place and reads the cell's numbers against the reference
at its own precision: TF32 for the federations' float32, float8 for the
train cells' bfloat16. The cells also read planted faults (half of each
batch left out, the mean taken over the rest; for the federations also the
weights left as local training found them), which set the upper readings of
the numbers the control cannot separate from sound runs. A
federation's control is followed by the reference from its weights at each
evaluated epoch, as the program is. Readings go to ``build/bench_control.jsonl``.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.drivers import dds_train
from bench.lib import federation as fed
from bench.lib import harness, inputs
from bench.reference import federation as fed_ref

SEEDS = (7001, 7002, 7003)
OUT = Path(__file__).resolve().parents[1] / "build" / "bench_control.jsonl"


def _record(**row):
    OUT.parent.mkdir(exist_ok=True)
    with OUT.open("a") as f:
        f.write(json.dumps(row) + "\n")
    print(row)


def as_outputs(out: dict) -> dict:
    """A reference run in the shape ``lib.federation.compare`` reads."""
    return {"contacts": out["contacts"], "kl_trace": out["kl_trace"],
            "loss": np.asarray(out["loss"]),
            "snaps": out["snaps"],
            "epochs": [e["epoch"] for e in out["evals"]],
            "accuracy": [e["accuracy"] for e in out["evals"]],
            "kl": [e["kl"] for e in out["evals"]], "entropy": [e["entropy"] for e in out["evals"]],
            "consensus": [e["consensus"] for e in out["evals"]],
            "params": {n: v.cpu() for n, v in out["params"].items()}}


def _not_correct(numbers: dict, limits: dict) -> bool:
    return any(limits.get(k) is None or v > limits[k] for k, v in numbers.items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mnist-cnn.k100.single", "mnist-cnn.k100.seeds8"])
@pytest.mark.parametrize("seed", SEEDS)
def test_federation_control_and_faults_fail(cuda_device, cell, seed):
    _, work, config = harness.cell_files(cell)
    h = work["traffic"]["horizon_epochs"]
    ds = inputs.synthetic_mnist(cuda_device, seed)
    data = fed.reference_data(ds, cuda_device)
    init = inputs.cnn_init(cuda_device, seed)
    cfg = dict(config, epochs=h)
    for kind, kw in (("tf32", {"mode": "tf32"}), ("half_batch", {"fault": "half_batch"}),
                     ("unchanged", {"fault": "unchanged"})):
        got = as_outputs(fed_ref.run(cfg, seed, data, init, **kw))
        want = fed_ref.run(cfg, seed, data, init, mode="f32", inject=got["snaps"])
        numbers = fed.compare(got, want)
        _record(cell=cell, seed=seed, kind=kind, **numbers)
        assert _not_correct(numbers, work["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["granite-moe-1b-a400m.train.v2-s4096",
                                  "granite-moe-1b-a400m.train.v2-s1024"])
@pytest.mark.parametrize("seed", SEEDS)
def test_train_control_and_fault_fail(cuda_device, cell, seed):
    _, work, config = harness.cell_files(cell)
    t, train = work["traffic"], config["training"]
    args = (config, seed, t["vehicles"], t["batch"], t["seq"], train["lr"], train["p1_steps"],
            cuda_device)
    want = dds_train.follow(*args)
    for kind, kw in (("fp8", {"mode": "fp8"}), ("half_batch", {"batch_share": 0.5})):
        got = dds_train.follow(*args, **kw)
        numbers = dds_train.compare(got, want)
        _record(cell=cell, seed=seed, kind=kind, **numbers)
        assert _not_correct(numbers, work["limits"])
    torch.cuda.empty_cache()
