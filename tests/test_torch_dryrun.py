"""The port's dry run (``launch/dryrun``) on a 4-rank ``fake`` group, at the
reduced dense architecture (qwen3-1.7b): a train round on the federation mesh
(vehicle 2 x fsdp 1 x model 2) and prefill / decode on a data 2 x model 2
mesh, every tensor on ``meta``.

Each record has the reference's keys and no error; its counts are per device:
``flops_per_device`` x 4 covers the unsharded step's count
(``roofline.flop_cost.analyze_fn`` with ``mesh=None``) and stays within 10 %
of it; ``traffic_bytes_per_device`` x 4 covers the unsharded traffic and is at
most twice it (data 2 replicates the reads of each model shard's weights);
decode on a pod x data x model mesh of 8 ranks moves about half the traffic
of the data x model mesh of 4 (its KV cache split twice as far); the train
round's collectives include the gossip mix's reduce-scatter (at least one
vehicle's local parameter shard), serving has gathers. The ragged MoE
(``ragged_moe``, the reduced granite-moe) runs train, prefill and decode: its
grouped products are custom ops with fake shapes and flop formulas, and their
flops come to top_k / num_experts of the dense experts'. A pair that cannot
run ends in an error record naming the port's line (a variant applied where
it does not apply). ``dryrun_pair`` and the CLI bring up
their own 256-rank group and tear it down (one cheap production pair).
The other families run in ``test_torch_dryrun_families.py`` and
``test_torch_dryrun_hybrid_vlm.py`` (``check_family``).
"""
import functools
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import aggregation
from repro_torch.launch import dryrun, shapes, steps
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer
from repro_torch.roofline import flop_cost

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH = "qwen3-1.7b"
KEYS = {"arch", "shape", "multi_pod", "mesh", "flops_per_device", "traffic_bytes_per_device",
        "collective_bytes_per_device", "memory_analysis", "run_s", "dtype"}
SHAPES = {"train": shapes.InputShape("train_small", 32, 8, "train"),
          "prefill": shapes.InputShape("prefill_small", 32, 4, "prefill"),
          "decode": shapes.InputShape("decode_small", 32, 16, "decode")}
P1_STEPS = 5


def small_mesh(kind: str):
    if kind == "train":
        return mesh_lib.make_federation_mesh(vehicle=2, fsdp=1, model=2, explicit=True)
    return mesh_lib._mesh((2, 2), ("data", "model"))


def run_small(arch: str, kind: str, **kw):
    return dryrun.run_pair(small_mesh(kind), arch, SHAPES[kind], get_config(arch).reduced(),
                           step_overrides={"p1_steps": P1_STEPS} if kind == "train" else None,
                           **kw)


def check_family(rec: dict, arch: str, kind: str) -> None:
    """What every family's record holds: the reference's keys, no error, a
    shard of the work, and collectives of its kind (the gossip mix's
    reduce-scatter on a train round)."""
    assert KEYS <= set(rec) and "error" not in rec, rec.get("error")
    assert rec["arch"] == arch and rec["shape"] == SHAPES[kind].name
    assert rec["flops_per_device"] > 0 and rec["traffic_bytes_per_device"] > 0
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
    coll = rec["collective_bytes_per_device"]
    if kind == "train":
        assert coll.get("reduce-scatter", 0) > 0
    assert coll.get("all-gather", 0) + coll.get("all-reduce", 0) > 0


@pytest.fixture
def fake4():
    """A 4-rank ``fake`` group; torn down with its meshes."""
    dryrun._fake_group(4)
    yield
    mesh_lib.shutdown()


@pytest.fixture(scope="module")
def records():
    """The three records, on a group torn down before any test runs."""
    dryrun._fake_group(4)
    try:
        return {kind: run_small(ARCH, kind) for kind in SHAPES}
    finally:
        mesh_lib.shutdown()


@functools.cache
def _unsharded(kind: str) -> dict:
    """The same step's flops and traffic on one device (``mesh=None``),
    counted on meta."""
    base, shape = get_config(ARCH).reduced(), SHAPES[kind]
    if kind == "train":
        cfg = base.pad_for_mesh(16)
        step = steps.build_dds_train_step(cfg, mix_params_fn=aggregation.mix_params,
                                          p1_steps=P1_STEPS)
        params, opt, sm = steps.train_state_specs(cfg, 2)
        ins = shapes.train_input_specs(cfg, shape, 2)
        args = [params, opt, sm, ins["tokens"], ins["contact"], ins["target"]]
    else:
        cfg = shapes.serve_cfg(base)
        params = transformer.init_params(torch.Generator(), cfg, device="meta")
        if kind == "prefill":
            step = steps.build_prefill_step(cfg)
            args = [params, shapes.prefill_input_specs(cfg, shape)["tokens"]]
        else:
            step = steps.build_decode_step(cfg)
            ins = shapes.decode_input_specs(cfg, shape)
            args = [params, ins["tokens"], ins["state"]]
    return flop_cost.analyze_fn(step.fn, *args)


@pytest.mark.parametrize("kind", list(SHAPES))
def test_record_has_the_reference_fields(records, kind):
    rec = records[kind]
    assert KEYS <= set(rec) and "error" not in rec
    assert rec["arch"] == ARCH and rec["shape"] == SHAPES[kind].name
    assert rec["dtype"] == "float32" and rec["multi_pod"] is False
    assert rec["mesh"] == ({"vehicle": 2, "fsdp": 1, "model": 2} if kind == "train"
                           else {"data": 2, "model": 2})
    mem = rec["memory_analysis"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes"}
    assert mem["argument_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
    assert rec["flops_per_device"] > 0 and rec["traffic_bytes_per_device"] > 0
    json.dumps(rec)                                    # a JSONL line as it stands


@pytest.mark.parametrize("kind", list(SHAPES))
def test_flops_are_per_device(records, kind):
    """Four ranks share the step's work: none is lost, and each does about a
    quarter (within 10 %) — the dispatch mode counts rank 0's local shards."""
    whole = _unsharded(kind)["flops_per_device"]
    per_device = records[kind]["flops_per_device"]
    assert per_device * 4 >= whole * (1 - 1e-9), (per_device, whole)
    assert per_device <= 1.1 * whole / 4, (per_device, whole / 4)


@pytest.mark.parametrize("kind", list(SHAPES))
def test_traffic_is_per_device(records, kind):
    """The bytes rank 0 moves: none of the step's lost, and at most twice an
    even quarter — the data axis (2) replicates the reads of each model
    shard's weights, and the norms read whole hidden vectors. Work that
    DTensor's sharding propagation does at the global shapes (on fake
    tensors of its own) is not the step's and is not counted."""
    whole = _unsharded(kind)["traffic_bytes_per_device"]
    per_device = records[kind]["traffic_bytes_per_device"]
    assert whole <= 4 * per_device <= 2 * whole, (4 * per_device / whole)


@pytest.fixture
def fake_group():
    """Brings up a ``fake`` group of the size asked for (the one before torn
    down); the last is torn down with its meshes."""
    def up(ranks: int) -> None:
        mesh_lib.shutdown()
        dryrun._fake_group(ranks)

    yield up
    mesh_lib.shutdown()


def test_multi_pod_decode_moves_half_the_traffic(fake_group):
    """A pod axis of 2 in front of data x model halves each rank's batch and
    so its share of the KV cache, which is most of decode's traffic at a
    512-token cache: traffic and flops per device about half (10 %)."""
    shape = shapes.InputShape("decode_pod", 512, 16, "decode")
    recs = {}
    for ranks, dims, names in ((4, (2, 2), ("data", "model")),
                               (8, (2, 2, 2), ("pod", "data", "model"))):
        fake_group(ranks)
        recs[ranks] = dryrun.run_pair(mesh_lib._mesh(dims, names), ARCH, shape,
                                      get_config(ARCH).reduced(), multi_pod=ranks == 8)
    for key in ("traffic_bytes_per_device", "flops_per_device"):
        ratio = recs[8][key] / recs[4][key]
        assert 0.45 <= ratio <= 0.55, (key, ratio)


def test_collectives_by_kind(records):
    train = records["train"]["collective_bytes_per_device"]
    cfg = get_config(ARCH).reduced().pad_for_mesh(16)
    params, _, _ = steps.train_state_specs(cfg, 2)
    one_shard = sum(x[0].numel() * 4 for x in steps.flatten(params).values()) / 2
    # the mix: one reduce-scatter per leaf of this rank's [1, ...] row shard
    assert train.get("reduce-scatter", 0) >= one_shard
    assert set(train) <= {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                          "collective-permute"}
    for kind in ("prefill", "decode"):
        coll = records[kind]["collective_bytes_per_device"]
        assert coll.get("all-gather", 0) + coll.get("all-reduce", 0) > 0, kind


class _GroupedFlops(dryrun.DeviceCounter):
    """The dry run's counter, also keeping the flops of the grouped products."""

    def __init__(self):
        super().__init__()
        self.grouped = 0
        _GroupedFlops.last = self

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func.namespace == "repro_torch" and out is not NotImplemented:
            self.grouped += self.flops - before
        return out


@pytest.mark.parametrize("kind", list(SHAPES))
def test_a_ragged_pair_runs_on_the_fake_mesh(fake4, kind, monkeypatch):
    """``ragged_moe`` on the reduced granite-moe: a record like any family's,
    and the grouped products' flops top_k / num_experts of the dense
    experts' (which are the dense pair's flops less everything else, the
    same in both pairs). The train round runs without remat here: with it,
    the dense path's recompute stops before its down product (whose output
    no gradient needs), the ragged path's does not (the combine weights'
    gradient needs it), which is one product more in twelve."""
    arch = "granite-moe-1b-a400m"
    cfg = get_config(arch).reduced()
    overrides = {"p1_steps": P1_STEPS, "remat": False} if kind == "train" else None

    def run(**kw):
        return dryrun.run_pair(small_mesh(kind), arch, SHAPES[kind], cfg,
                               step_overrides=overrides, **kw)

    dense = run()
    monkeypatch.setattr(dryrun, "DeviceCounter", _GroupedFlops)
    rec = run(variant="ragged_moe")
    check_family(rec, arch, kind)
    assert rec["variant"] == "ragged_moe"
    grouped = _GroupedFlops.last.grouped
    dense_experts = dense["flops_per_device"] - (rec["flops_per_device"] - grouped)
    ratio = grouped / dense_experts
    assert abs(ratio - cfg.top_k / cfg.num_experts) <= 0.02, ratio


def test_a_pair_that_cannot_run_records_its_line(fake4):
    """A variant applied where it does not apply (``ragged_moe`` on a dense
    architecture) fails the pair at the port's line that refused it."""
    with pytest.raises(Exception) as err:
        run_small(ARCH, "prefill", variant="ragged_moe")
    rec = dryrun.error_record(ARCH, "prefill_small", False, err.value)
    assert set(rec) == {"arch", "shape", "multi_pod", "error"}
    assert "launch/variants.py:" in rec["error"] and "not applicable" in rec["error"]


def test_dryrun_pair_and_cli_bring_up_and_tear_down_their_group(tmp_path, capsys):
    assert not dist.is_initialized()
    out = tmp_path / "records.jsonl"
    dryrun.main(["--arch", ARCH, "--shape", "long_500k", "--out", str(out)])
    assert not dist.is_initialized() and not mesh_lib._MESHES
    rec = json.loads(out.read_text())
    assert rec["mesh"] == {"data": 16, "model": 16} and "error" not in rec
    assert rec["collective_bytes_per_device"]
    assert "[OK] qwen3-1.7b x long_500k (16x16)" in capsys.readouterr().out
    # a failing pair: the sweep goes on, the record holds the error, exit non-zero
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", "long_500k", "--variant", "ragged_moe", "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert cli.returncode != 0 and "1 dry-run failures" in cli.stderr
    failed = json.loads(out.read_text().splitlines()[-1])
    assert "launch/variants.py:" in failed["error"] and failed["variant"] == "ragged_moe"
