"""The port's checkpoints (``repro_torch.checkpoint``) and training entry point
(``repro_torch.launch.train``).

A checkpoint written by either package restores in the other: both flatten
a tree by ``/``-joined key path into one ``.npz``. The entry point's CNN
branch runs a federation and checkpoints its accuracy history, as the reference's
does; its transformer branch runs the DDS rounds of ``launch/steps.py``
(held to the reference in ``test_torch_train_step.py``).
"""
import collections
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro_torch import checkpoint as ckpt
from repro_torch.launch import train

ROOT = Path(__file__).resolve().parent.parent
Moments = collections.namedtuple("Moments", "count mu")


def _numpy_tree(seed: int = 0) -> dict:
    r = np.random.default_rng(seed)
    return {
        "params": {"conv1_w": r.normal(size=(5, 5, 1, 10)).astype(np.float32),
                   "fc_b": r.normal(size=(10,)).astype(np.float32)},
        "stack": [r.normal(size=(3,)).astype(np.float32),
                  r.integers(0, 9, size=(2, 2)).astype(np.int32)],
        "opt": Moments(np.int32(7), r.normal(size=(4,)).astype(np.float32)),
    }


def _torch_tree(tree: dict) -> dict:
    """The same tree with every leaf a tensor."""
    return {"params": {k: torch.as_tensor(v) for k, v in tree["params"].items()},
            "stack": [torch.as_tensor(v) for v in tree["stack"]],
            "opt": Moments(torch.as_tensor(tree["opt"].count),
                           torch.as_tensor(tree["opt"].mu))}


def _zeros_like(tree: dict) -> dict:
    return torch.utils._pytree.tree_map(torch.zeros_like, tree)


def _assert_same(got: dict, want: dict) -> None:
    g, spec_g = torch.utils._pytree.tree_flatten(got)
    w, spec_w = torch.utils._pytree.tree_flatten(want)
    assert spec_g == spec_w
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


# ------------------------------------------------------------ checkpoint ----

def test_save_restore_round_trip(tmp_path):
    tree = _torch_tree(_numpy_tree())
    ckpt.save(str(tmp_path / "a"), tree, {"epoch": 3})
    assert (tmp_path / "a.npz").exists()
    _assert_same(ckpt.restore(str(tmp_path / "a"), _zeros_like(tree)), tree)
    assert ckpt.metadata(str(tmp_path / "a.npz")) == {"epoch": 3}


def test_restore_takes_the_dtype_of_like(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7}
    ckpt.save(str(tmp_path / "b.npz"), {"w": tree["w"].to(torch.bfloat16)})
    got = ckpt.restore(str(tmp_path / "b.npz"), {"w": torch.zeros(2, 3, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], tree["w"].to(torch.bfloat16))
    numpy_like = ckpt.restore(str(tmp_path / "b.npz"), {"w": np.zeros((2, 3), np.float64)})
    assert numpy_like["w"].dtype == np.float64


def test_restore_checks_shapes_and_keys(tmp_path):
    ckpt.save(str(tmp_path / "c.npz"), {"w": torch.ones(2, 3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path / "c.npz"), {"w": torch.ones(3, 2)})
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(str(tmp_path / "c.npz"), {"v": torch.ones(2, 3)})


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _numpy_tree(1)
    ref_ckpt.save(str(tmp_path / "ref"), tree, {"algorithm": "dds"})
    got = ckpt.restore(str(tmp_path / "ref"), _zeros_like(_torch_tree(tree)))
    _assert_same(got, _torch_tree(tree))
    assert ckpt.metadata(str(tmp_path / "ref")) == {"algorithm": "dds"}


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _numpy_tree(2)
    ckpt.save(str(tmp_path / "port"), _torch_tree(tree), {"algorithm": "dds"})
    like = {"params": {k: np.zeros_like(v) for k, v in tree["params"].items()},
            "stack": [np.zeros_like(v) for v in tree["stack"]],
            "opt": Moments(np.int32(0), np.zeros_like(tree["opt"].mu))}
    got = ref_ckpt.restore(str(tmp_path / "port"), like)
    for key in tree["params"]:
        np.testing.assert_array_equal(np.asarray(got["params"][key]), tree["params"][key])
    for a, b in zip(got["stack"], tree["stack"]):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(got["opt"].count) == 7
    np.testing.assert_array_equal(np.asarray(got["opt"].mu), tree["opt"].mu)
    assert ref_ckpt.metadata(str(tmp_path / "port")) == {"algorithm": "dds"}


def test_the_two_packages_write_the_same_keys(tmp_path):
    tree = _numpy_tree(3)
    ref_ckpt.save(str(tmp_path / "ref"), tree)
    ckpt.save(str(tmp_path / "port"), _torch_tree(tree))
    with np.load(tmp_path / "ref.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            if key != "__treedef__":
                np.testing.assert_array_equal(a[key], b[key])


def test_manager_retention_and_latest(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "m"), keep=2)
    for step in (1, 2, 3, 10):
        mgr.save(step, {"x": torch.full((2,), float(step))})
    assert sorted(os.listdir(tmp_path / "m")) == ["ckpt_10.npz", "ckpt_3.npz"]
    assert mgr.latest_step() == 10
    tree, step = mgr.restore_latest({"x": torch.zeros(2)})
    assert step == 10 and torch.equal(tree["x"], torch.full((2,), 10.0))
    assert ckpt.metadata(os.path.join(tmp_path, "m", "ckpt_10.npz")) == {"step": 10}
    assert ckpt.CheckpointManager(str(tmp_path / "empty")).restore_latest({}) is None


def test_a_failed_write_leaves_the_old_checkpoint(tmp_path, monkeypatch):
    path = str(tmp_path / "d.npz")
    ckpt.save(path, {"w": torch.ones(3)})

    def broken_savez(f, **payload):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken_savez)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save(path, {"w": torch.zeros(3)})
    assert os.listdir(tmp_path) == ["d.npz"]            # no temporary file left
    monkeypatch.undo()
    assert torch.equal(ckpt.restore(path, {"w": torch.zeros(3)})["w"], torch.ones(3))


# ------------------------------------------------------------- train CLI ----

def test_train_cli_runs_a_federation_and_checkpoints_its_history(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mnist-cnn",
         "--device", "cpu", "--vehicles", "6", "--epochs", "2", "--eval-every", "1",
         "--local-steps", "1", "--batch-size", "16", "--checkpoint-dir", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, timeout=240,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "")})
    assert out.returncode == 0, out.stderr
    printed = [float(line.split("avg_acc=")[1].split()[0])
               for line in out.stdout.splitlines() if "avg_acc=" in line]
    assert len(printed) == 2
    history, step = ckpt.CheckpointManager(str(tmp_path)).restore_latest(
        {"avg_accuracy": torch.zeros(2, dtype=torch.float64)})
    assert step == 2
    np.testing.assert_allclose(history["avg_accuracy"].numpy(), printed, atol=5e-5)
    assert ckpt.metadata(str(tmp_path / "ckpt_2.npz")) == {"algorithm": "dds", "step": 2}
    # the reference's package reads the same file
    ref = ref_ckpt.restore(str(tmp_path / "ckpt_2.npz"), {"avg_accuracy": np.zeros(2)})
    np.testing.assert_array_equal(np.asarray(ref["avg_accuracy"]),
                                  history["avg_accuracy"].numpy())


def test_train_cli_auto_stamps_the_plan_in_the_checkpoint(tmp_path, capsys):
    res = train.main(["--arch", "mnist-cnn", "--device", "cpu", "--vehicles", "6",
                      "--epochs", "1", "--eval-every", "1", "--local-steps", "1",
                      "--batch-size", "8", "--execution", "auto",
                      "--checkpoint-dir", str(tmp_path)])
    assert res.config.execution == "manual" and res.execution_plan["requested"] == "auto"
    meta = ckpt.metadata(str(tmp_path / "ckpt_1.npz"))
    assert meta["execution_plan"] == res.execution_plan
    assert "execution plan:" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x7b"])
def test_train_cli_transformer_arch_names_launch_steps(arch, monkeypatch):
    """A transformer ``--arch`` trains through ``launch.steps``'s round."""
    build = train.steps_lib.build_dds_train_step
    built = []

    def spy(cfg, **kw):
        built.append((cfg.name, kw))
        return build(cfg, **kw)

    monkeypatch.setattr(train.steps_lib, "build_dds_train_step", spy)
    _, opt_state, _, history = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                                           "--vehicles", "2", "--steps", "1", "--seq-len", "8"])
    assert built == [(f"{arch}-reduced", {"lr": 1e-3, "remat": False, "p1_steps": 100})]
    assert opt_state.count.tolist() == [1, 1] and np.isfinite(history[0]["loss"])


def test_train_cli_device_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "mnist-cnn", "--vehicles", "4", "--epochs", "1"])
