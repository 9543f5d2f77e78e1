"""The manifest (``BENCHMARK.json``) against the benchmark's contract, and
every file the harness finds by name."""
import json
import re
from pathlib import Path

import pytest

from bench.lib import harness

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["bench"]
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_no_four_chip_cell_and_one_pair_each():
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_bounds():
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_it_needs(cell):
    e2e = [m["name"] for m in harness.metrics_of(BENCH, "end_to_end", cell)]
    layers = harness.metrics_of(BENCH, "per_layer", cell)
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in layers:
        # the end-to-end metric a per-layer metric moves is reported there
        assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    entry, work, config = harness.cell_files(cell, BENCH)
    assert work["name"] == cell and work["chips"] == entry["chips"]
    assert (ROOT / "bench" / "drivers" / f"{work['driver']}.py").exists()
    assert work["rate_metric"] in [m["name"] for m in harness.metrics_of(BENCH, "end_to_end", cell)]
    assert set(work["limits"]) and all(v is not None for v in work["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(harness.load_reader(metric))


def test_configs():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("bench/") and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(x) <= 200 and "\n" not in x for x in layers)
