"""The two train cells added after the first four: CPU rehearsals at reduced
sizes (a sound run and every planted fault), and their controls on the card
(run there with ``python -m pytest -q -s -m cuda bench/test_bench_added_cells.py``;
skipped without a card).

* ``moonlight-16b-a3b.train.v2-s8192`` (driver ``dds_train_mla``): the faults
  are the train cells' (weights left unchanged, half of the tokens, the
  state matrix not mixed) and three of latent attention and the MoE (the
  shared rotary key left unrotated, the routed weights taken from the
  biased scores, the shared experts left out). On the card the reference
  computed in float8 and the reference-side faults are held to the cell's
  limits; readings go to ``build/bench_control.jsonl``.
* ``granite-moe-1b-a400m.train.v2-s4096-f32`` (driver ``dds_train_variant``,
  the ``baseline`` variant): the same three train faults, and the
  ``opt_ragged`` variant (bf16 compute and payload) run under the f32
  cell's limits, which it must fail.

The CPU runs the Moonlight cell under ``ragged_moe`` without bf16, as
``test_bench_rehearsal`` does for granite.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from bench.drivers import dds_train, dds_train_mla
from bench.lib import harness
from bench.test_bench_rehearsal import SEED, _train_faults

MOON = "moonlight-16b-a3b.train.v2-s8192"
F32 = "granite-moe-1b-a400m.train.v2-s4096-f32"
OUT = Path(__file__).resolve().parents[1] / "build" / "bench_control.jsonl"


def overrides(cell: str) -> dict:
    config, traffic = harness.cell_files(cell)[2], harness.cell_files(cell)[1]["traffic"]
    if cell == MOON:
        return {"traffic": {"vehicles": 2, "batch": 2, "seq": 16},
                "config": {"num_hidden_layers": 3, "hidden_size": 64, "num_attention_heads": 4,
                           "num_key_value_heads": 4, "kv_lora_rank": 16, "qk_nope_head_dim": 24,
                           "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 96,
                           "moe_intermediate_size": 32, "router_experts": 8,
                           "n_routed_experts": 4, "num_experts_per_tok": 2, "vocab_size": 128,
                           "training": dict(config["training"], variant="ragged_moe")}}
    return {"traffic": dict(traffic, batch=2, seq=16),
            "config": {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
                       "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 32,
                       "num_local_experts": 4, "num_experts_per_tok": 2, "vocab_size": 128}}


def rehearse(cell: str, traced: bool = False, **traffic) -> dict:
    o = overrides(cell)
    o["traffic"].update(traffic)
    return harness.run_cell(cell, SEED, 0.5, traced, "cpu", overrides=o)


def _mla_faults():
    from repro_torch.models import layers, moe

    rotate, route, ffn = layers.apply_rotary_interleaved, moe.router_sigmoid, moe.moe_ffn

    def k_pe_unrotated(x, cos, sin):
        if x.shape[-2] != 1:                   # the queries' heads: turned as before
            return rotate(x, cos, sin)
        return torch.cat([x[..., 0::2], x[..., 1::2]], -1)      # the shared key: angle 0

    def weights_from_biased(logits, bias, top_k, scale, batch=1):
        _, idx, aux = route(logits, bias, top_k, scale, batch)
        w = (torch.sigmoid(logits.float()) + bias.float()).gather(1, idx)
        return (w / w.sum(-1, keepdim=True) * scale).to(logits.dtype), idx, aux

    def no_shared(p, x, cfg, timer=None):
        return ffn(p, x, dataclasses.replace(cfg, shared_experts=0), timer)

    return {"k_pe_unrotated": (layers, "apply_rotary_interleaved", k_pe_unrotated),
            "weights_from_biased": (moe, "router_sigmoid", weights_from_biased),
            "no_shared": (moe, "moe_ffn", no_shared)}


@pytest.mark.parametrize("cell", [MOON, F32])
def test_sound_rehearsal_is_correct_and_reads_its_layers(cell):
    result = rehearse(cell)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(harness.cell_files(cell)[1]["limits"])
    for name, c in result["checks"].items():
        assert c["value"] <= max(1e-5, 0.01 * c["limit"]), (name, c)
    traced = rehearse(cell, traced=True)
    metrics = harness.metrics_of(harness.manifest(), "per_layer", cell)
    names = {m["name"] for m in metrics}
    spans = {m["name"] for m in metrics if m["source"] == "program_span"}
    assert traced["correct"] and spans <= set(traced["metrics"]) <= names
    for n in spans:
        assert traced["metrics"][n]["value"] > 0, n


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "state_matrix_not_mixed",
                                   "k_pe_unrotated", "weights_from_biased", "no_shared"])
def test_moonlight_fault_is_caught(fault, monkeypatch):
    module, name, broken = {**_train_faults(), **_mla_faults()}[fault]
    monkeypatch.setattr(module, name, broken)
    result = rehearse(MOON)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "state_matrix_not_mixed"])
def test_f32_cell_fault_is_caught(fault, monkeypatch):
    module, name, broken = _train_faults()[fault]
    monkeypatch.setattr(module, name, broken)
    assert not rehearse(F32)["correct"]


def test_f32_cell_refuses_the_bf16_variant():
    result = rehearse(F32, variant="opt_ragged")
    assert not result["correct"], result["checks"]


def test_the_parent_driver_cannot_run_the_moonlight_cell(monkeypatch):
    """Without the program's Moonlight configuration the driver stops at
    once with an error (a commit before the port had one)."""
    import sys
    monkeypatch.setitem(sys.modules, "repro_torch.configs.moonlight_16b_a3b", None)
    with pytest.raises(ImportError):
        rehearse(MOON)


def test_moonlight_costs_are_pinned():
    """bench/costs/moonlight at the cell's cut: 644.6 M matmul parameters a
    token passes, counted term by term."""
    from bench.costs import moonlight

    config = harness.cell_files(MOON)[2]
    attn = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    moe = 2048 * 64 + 2 * 3 * 2048 * 1408 + 6 * 8 / 64 * 3 * 2048 * 1408
    want = 7 * attn + 3 * 2048 * 11264 + 6 * moe + 163840 * 2048
    assert moonlight.active_matmul_params(config) == pytest.approx(want)
    assert want == pytest.approx(644_612_096)
    assert moonlight.token_flops(config, 8192) == pytest.approx(
        6 * want + 3 * 7 * 16 * (192 + 128) * 8192)
    assert moonlight.round_flops(config, 2, 1, 8192) == pytest.approx(7.7799e13, rel=1e-4)


def _record(**row):
    OUT.parent.mkdir(exist_ok=True)
    with OUT.open("a") as f:
        f.write(json.dumps(row) + "\n")
    print(row)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", (7001, 7002, 7003))
def test_moonlight_control_and_faults_fail(cuda_device, seed):
    """At the cell's own size: the reference in float8, on half of the
    tokens, with its weights left unchanged (AdamW's step not applied) and
    with each MLA / MoE fault, against the f32 reference."""
    _, work, config = harness.cell_files(MOON)
    t, train = work["traffic"], config["training"]
    args = (config, seed, t["vehicles"], t["batch"], t["seq"], train["lr"], train["p1_steps"],
            cuda_device)
    want = dds_train_mla.follow(*args)
    _record(cell=MOON, seed=seed, kind="bias_share", value=want["bias_share"])
    passed = []
    for kind, kw in (("fp8", {"mode": "fp8"}), ("half_batch", {"batch_share": 0.5}),
                     ("weights_unchanged", {"fault": "weights_unchanged"}),
                     ("k_pe_unrotated", {"fault": "k_pe_unrotated"}),
                     ("weights_from_biased", {"fault": "weights_from_biased"}),
                     ("no_shared", {"fault": "no_shared"})):
        numbers = dds_train_mla.compare_experts(dds_train_mla.follow(*args, **kw), want)
        _record(cell=MOON, seed=seed, kind=kind, **numbers)
        if all(numbers[k] <= limit for k, limit in work["limits"].items()):
            passed.append(kind)
    torch.cuda.empty_cache()
    assert not passed, passed


@pytest.mark.cuda
@pytest.mark.parametrize("seed", (7001, 7002, 7003, 7004))
def test_f32_cell_control_and_fault_fail(cuda_device, seed, monkeypatch):
    """The f32 cell's control: the reference with its products in TF32 (the
    precision below f32), and on half of the tokens, against it in f32."""
    from bench.reference import federation as fed_ref

    _, work, config = harness.cell_files(F32)
    t, train = work["traffic"], config["training"]
    args = (config, seed, t["vehicles"], t["batch"], t["seq"], train["lr"], train["p1_steps"],
            cuda_device)
    want = dds_train.follow(*args)
    precision, passed = fed_ref.precision, []
    for kind in ("tf32", "half_batch"):
        with monkeypatch.context() as m:
            if kind == "tf32":
                m.setattr(fed_ref, "precision", lambda mode: precision("tf32"))
            got = dds_train.follow(*args, batch_share=0.5 if kind == "half_batch" else 1.0)
        numbers = dds_train.compare(got, want)
        _record(cell=F32, seed=seed, kind=kind, **numbers)
        if all(v <= work["limits"][k] for k, v in numbers.items()):
            passed.append(kind)
    torch.cuda.empty_cache()
    assert not passed, passed


@pytest.mark.cuda
def test_f32_cell_refuses_the_bf16_variant_on_the_card(cuda_device):
    result = harness.run_cell(F32, 7003, 5.0, False, cuda_device, overrides={
        "traffic": dict(harness.cell_files(F32)[1]["traffic"], variant="opt_ragged")})
    _record(cell=F32, seed=7003, kind="opt_ragged",
            **{k: c["value"] for k, c in result["checks"].items()})
    assert not result["correct"], result["checks"]
