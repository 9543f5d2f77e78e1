"""CPU rehearsals of every driver against its reference at reduced sizes,
and the faults the comparison has to catch.

Each runs the harness's ``run_cell`` as the command runs it on the card, but
on the CPU (the look for a card skipped) and with the cell's sizes cut by
``overrides``: the program's window, then its comparison with the plain
reference. The faults break the timed path underneath (a step that returns
its state unchanged, half of the batch left out with the mean over the rest,
the exchange between vehicles left out, an answer altered where it is
produced) and ``correct`` has to come out false. The train cells run the
variant without bfloat16 here (the CPU's bf16 is another arithmetic than the
card's): the program and the reference then agree to f32 rounding.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from bench.lib import harness

ROOT = Path(__file__).resolve().parents[1]
FED_CELLS = ["mnist-cnn.k100.single", "mnist-cnn.k100.seeds8"]
TRAIN_CELLS = ["granite-moe-1b-a400m.train.v2-s4096", "granite-moe-1b-a400m.train.v2-s1024"]
SEED = 3_000_000_017        # over 32 bits, as a run's seed may be


def overrides(cell: str) -> dict:
    if cell in FED_CELLS:
        return {"traffic": {"horizon_epochs": 4, "seeds_per_call": 2,
                            "data": {"n_train": 2400, "n_test": 200}},
                "config": {"num_vehicles": 6, "local_steps": 2, "batch_size": 16,
                           "p1_steps": 30, "eval_samples": 100, "eval_every": 2}}
    config = harness.cell_files(cell)[2]
    return {"traffic": {"vehicles": 2, "batch": 2, "seq": 16},
            "config": {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
                       "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 32,
                       "num_local_experts": 4, "num_experts_per_tok": 2, "vocab_size": 128,
                       "training": dict(config["training"], variant="ragged_moe")}}


def rehearse(cell: str, traced: bool = False, seconds: float = 0.5) -> dict:
    return harness.run_cell(cell, SEED, seconds, traced, "cpu", overrides=overrides(cell))


@pytest.mark.parametrize("cell", FED_CELLS + TRAIN_CELLS)
def test_sound_run_is_correct(cell):
    result = rehearse(cell)
    assert result["correct"], result["checks"]
    limits = harness.cell_files(cell)[1]["limits"]
    assert set(result["checks"]) == set(limits)
    # f32 on both sides: far inside every limit
    for name, c in result["checks"].items():
        assert c["value"] <= max(1e-5, 0.01 * c["limit"]), (name, c)
    e2e = [m["name"] for m in harness.metrics_of(harness.manifest(), "end_to_end", cell)]
    assert set(result["metrics"]) == set(e2e)
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", FED_CELLS + TRAIN_CELLS)
def test_traced_run_reads_its_layers(cell):
    result = rehearse(cell, traced=True)
    assert result["correct"]
    assert "busy_s" in result["device"] and "breakdown" in result
    names = {m["name"] for m in harness.metrics_of(harness.manifest(), "per_layer", cell)}
    # the host spans and phase spans read on the CPU too; device shares do not
    assert set(result["metrics"]) <= names
    host = {n for n in names if n.startswith(("build_ms", "contact_ms"))}
    assert host <= set(result["metrics"])


def _fed_faults():
    from repro_torch.core import dfl_dds, state_vector
    from repro_torch.fed import engine
    from repro_torch.models import cnn

    round_fn, nll, kl = dfl_dds.dds_round, cnn.nll_loss, state_vector.kl_to_target

    def unchanged(fed, *args, **kwargs):
        out, diags = round_fn(fed, *args, **kwargs)
        return out._replace(params=fed.params), diags

    def half_batch(log_probs, labels):
        half = log_probs.shape[-2] // 2
        return nll(log_probs[..., :half, :], labels[..., :half])

    def no_exchange(cfg):
        return lambda mixing, params: dict(params)

    def altered(state, target, eps=1e-12):
        out = kl(state, target, eps)
        return out + (torch.arange(out.shape[-1]) == 0).to(out.dtype) * 1e-2

    return {"state_unchanged": (dfl_dds, "dds_round", unchanged),
            "half_batch": (cnn, "nll_loss", half_batch),
            "exchange_left_out": (engine, "resolve_mix_params_fn", no_exchange),
            "answer_altered": (state_vector, "kl_to_target", altered)}


def _train_faults():
    from repro_torch.core import state_vector
    from repro_torch.launch import steps
    from repro_torch.models import layers, transformer

    ce, loss = layers.cross_entropy, transformer.lm_loss

    def half_batch(logits, labels, ignore_id=-1):
        half = logits.shape[0] // 2
        return ce(logits[:half], labels[:half], ignore_id)

    def altered(*args, **kwargs):
        return loss(*args, **kwargs) * 1.01

    return {"state_unchanged": (steps, "apply_updates", lambda params, updates: dict(params)),
            "half_batch": (layers, "cross_entropy", half_batch),
            "answer_altered": (transformer, "lm_loss", altered),
            "state_matrix_not_mixed": (state_vector, "aggregate", lambda state, mixing: state)}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "exchange_left_out",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", FED_CELLS)
def test_federation_fault_is_caught(cell, fault, monkeypatch):
    module, name, broken = _fed_faults()[fault]
    monkeypatch.setattr(module, name, broken)
    assert not rehearse(cell)["correct"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered",
                                   "state_matrix_not_mixed"])
@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_train_fault_is_caught(cell, fault, monkeypatch):
    module, name, broken = _train_faults()[fault]
    monkeypatch.setattr(module, name, broken)
    result = rehearse(cell)
    assert not result["correct"]
    if fault == "state_matrix_not_mixed":
        # the state matrix alone departs: P1's weights never reach it
        failed = {k for k, c in result["checks"].items() if c["value"] > c["limit"]}
        assert failed == {"state_gap"}, result["checks"]


@pytest.mark.parametrize("where", ["comparison", "reader"])
def test_a_module_loaded_after_the_window_refuses_the_result(where, monkeypatch):
    """A forbidden module that the comparison or a per-layer reader loads,
    after the window's own look, still leaves the run with no result."""
    from bench.drivers import dds_train

    def load(*args):
        monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))

    if where == "comparison":
        finish = dds_train.Driver.finish
        monkeypatch.setattr(dds_train.Driver, "finish", lambda d: (load(), finish(d))[1])
    else:
        reader = harness.load_reader
        monkeypatch.setattr(harness, "load_reader",
                            lambda name: (load(), reader(name))[1])
    with pytest.raises(SystemExit, match="flax"):
        harness.run_cell(TRAIN_CELLS[1], SEED, 0.5, where == "reader", "cpu",
                         overrides=overrides(TRAIN_CELLS[1]))


@pytest.mark.parametrize("cell", [FED_CELLS[0], TRAIN_CELLS[0]])
def test_a_run_loads_no_jax_and_no_reference_package(cell):
    """In a fresh process, after a whole rehearsal, no module whose top-level
    name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` is loaded
    (``repro_torch`` is another name)."""
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from bench import test_bench_rehearsal as t\n"
        "from bench.lib import harness\n"
        f"r = t.rehearse({cell!r})\n"
        "print(json.dumps({'found': harness.forbidden_modules(), 'correct': r['correct'],\n"
        "                  'torch_port': 'repro_torch' in sys.modules}))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"found": [], "correct": True, "torch_port": True}


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", FED_CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
