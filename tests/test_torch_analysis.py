"""Port vs reference, the roofline of the dry-run records
(``roofline/analysis``): ``model_flops`` for every architecture x shape;
``analyze_record`` with the reference's TPU constants passed in, field by
field against the reference's row on hand-written records (each term
dominant in turn, a multi-pod mesh, a failed record); the H100 defaults by
the record's dtype; ``markdown_table`` and the CLI on a temporary JSONL.
"""
import dataclasses
import json

import pytest

from repro.launch import shapes as jshapes
from repro.roofline import analysis as janalysis
from repro.roofline import hw as jhw
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.roofline import analysis, hw

TPU = dict(peak_flops=jhw.PEAK_FLOPS, hbm_bytes_per_s=jhw.HBM_BW,
           link_bytes_per_s=jhw.ICI_LINK_BW)

RECORDS = [
    {"arch": "qwen3-1.7b", "shape": "train_4k", "mesh": {"vehicle": 16, "fsdp": 1, "model": 16},
     "flops_per_device": 1e15, "traffic_bytes_per_device": 1e9,
     "collective_bytes_per_device": {"all-gather": 1e9}},
    {"arch": "mixtral-8x7b", "shape": "decode_32k", "mesh": {"data": 16, "model": 16},
     "flops_per_device": 3e9, "traffic_bytes_per_device": 4e12,
     "collective_bytes_per_device": {"all-gather": 2e8, "reduce-scatter": 1e6}},
    {"arch": "rwkv6-3b", "shape": "prefill_32k", "mesh": {"pod": 2, "data": 16, "model": 16},
     "flops_per_device": 1e12, "traffic_bytes_per_device": 1e9,
     "collective_bytes_per_device": {"all-reduce": 5e12, "all-to-all": 1.0}},
    {"arch": "granite-moe-1b-a400m", "shape": "long_500k", "mesh": {"data": 16, "model": 16},
     "flops_per_device": 0.0, "traffic_bytes_per_device": 1.0,
     "collective_bytes_per_device": {}},
]


@pytest.mark.parametrize("shape", sorted(jshapes.INPUT_SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_model_flops_equals_reference(arch, shape):
    assert analysis.model_flops(arch, shape) == janalysis.model_flops(arch, shape)


@pytest.mark.parametrize("rec", RECORDS, ids=lambda r: f"{r['arch']}-{r['shape']}")
def test_rows_with_the_tpu_constants_equal_reference(rec):
    got = analysis.analyze_record(rec, **TPU)
    want = janalysis.analyze_record(rec)
    got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    assert sorted(got) == sorted(want)
    for key in got:
        if key == "suggestion":                 # rewritten for the card, same keys
            continue
        if key == "useful_ratio" and want[key] != want[key]:
            assert got[key] != got[key]         # both nan (no flops)
            continue
        assert got[key] == want[key], key
    assert got["suggestion"] == analysis._SUGGESTIONS[got["dominant"]]


def test_suggestions_keep_the_keys_and_speak_of_the_card():
    assert sorted(analysis._SUGGESTIONS) == sorted(janalysis._SUGGESTIONS)
    text = " ".join(analysis._SUGGESTIONS.values())
    assert "CUDA" in text and "NVLink" in text
    assert "Pallas" not in text and "ICI" not in text


def test_h100_defaults_follow_the_dtype():
    rec = dict(RECORDS[0])
    row = analysis.analyze_record(rec)
    assert row.compute_s == rec["flops_per_device"] / hw.F32_FLOP_PER_S
    assert row.memory_s == rec["traffic_bytes_per_device"] / hw.HBM_BYTES_PER_S
    assert row.collective_s == 1e9 / hw.NVLINK_BYTES_PER_S
    assert row.chips == 256 and row.mesh == "16x1x16"
    for dtype, peak in (("bfloat16", hw.BF16_FLOP_PER_S), ("tf32", hw.TF32_FLOP_PER_S)):
        assert analysis.analyze_record({**rec, "dtype": dtype}).compute_s == 1e15 / peak
    assert row.step_time_bound_s() == max(row.compute_s, row.memory_s, row.collective_s)
    assert analysis.analyze_record({"arch": "qwen3-1.7b", "shape": "train_4k",
                                    "error": "x"}) is None
    assert analysis.analyze_record({"arch": "qwen3-1.7b", "shape": "train_4k"}) is None


def test_markdown_table_and_cli(tmp_path, capsys):
    path = tmp_path / "records.jsonl"
    lines = [json.dumps(r) for r in RECORDS] + [
        json.dumps({"arch": "qwen3-1.7b", "shape": "train_4k", "error": "boom"}), ""]
    path.write_text("\n".join(lines))
    rows = analysis.load_rows([str(path)], **TPU)
    assert len(rows) == len(RECORDS)
    assert analysis.markdown_table(rows) == janalysis.markdown_table(
        janalysis.load_rows([str(path)]))
    analysis.main([str(path)])
    out = capsys.readouterr().out
    assert out.startswith("| arch | shape | mesh |") and "-bound -> " in out
    assert out.count("\n| ") == len(RECORDS)             # one row per record, after the rule
    analysis.main([str(path), "--json"])
    got = json.loads(capsys.readouterr().out)
    assert [r["arch"] for r in got] == [r["arch"] for r in RECORDS]
    assert got[0]["compute_s"] == RECORDS[0]["flops_per_device"] / hw.F32_FLOP_PER_S
