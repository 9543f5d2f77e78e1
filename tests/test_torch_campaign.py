"""The port's campaign layer: ``spec_hash`` equal to the reference's for
every smoke scenario, the results store, the cache hit of a second
``run_campaign``, the sweep and figure CLIs on the CPU, and the registries'
markdown against the reference's registries.
"""
import json
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

import benchmarks.run  # noqa: F401 — registers the reference's figures
from benchmarks import common as ref_common
from repro import registries as ref_registries
from repro.launch import campaign as ref_campaign
from repro_torch import registries
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.figures import common
from repro_torch.fed.engine import SimulationConfig
from repro_torch.launch import campaign as campaign_lib
from repro_torch.launch import report as report_lib
from repro_torch.launch import sweep as sweep_lib
from repro_torch.launch.results_store import ResultsStore, jsonable

ROOT = Path(__file__).resolve().parent.parent
SIG = ["synthetic-mnist", 6000, 1000]


def _tiny(**kw):
    base = dict(num_vehicles=6, epochs=3, eval_every=3, eval_samples=100,
                local_steps=1, batch_size=8, p1_steps=10, lr=0.15, device="cpu")
    base.update(kw)
    return SimulationConfig(**base)


# ------------------------------------------------------------------- hashing

def _smoke_keys():
    keys = []
    for name in common.DEFAULT_FIGURES:
        for key in campaign_lib.get_figure(name).scenario_keys():
            if key not in keys:
                keys.append(key)
    return keys


def test_smoke_scenarios_hash_as_the_reference():
    """Every scenario of the default smoke campaign: same semantic config,
    seeds and dataset signature -> the reference's spec_hash, although the
    port's config carries ``device`` and another ``mixing_backend`` default."""
    ref_base, base = ref_common.tier_base("smoke"), common.tier_base("smoke", device="cpu")
    assert base.mixing_backend != ref_base.mixing_backend
    keys = _smoke_keys()
    assert len(keys) == 12
    ref_keys = []
    for name in ref_common.DEFAULT_FIGURES:
        for k in ref_campaign.get_figure(name).scenario_keys():
            if k not in ref_keys:
                ref_keys.append(k)
    assert keys == ref_keys
    for key in keys:
        for seeds in ((0, 1, 2), (3,)):
            want = ref_campaign.spec_hash(ref_campaign.scenario_config(ref_base, key),
                                          seeds, SIG)
            got = campaign_lib.spec_hash(campaign_lib.scenario_config(base, key), seeds, SIG)
            assert got == want, key


def test_spec_hash_ignores_execution_knobs_and_device():
    cfg = _tiny()
    h = campaign_lib.spec_hash(cfg, (0, 1), SIG)
    for knob in (dict(device="cuda"), dict(mixing_backend="torch"),
                 dict(use_scan_engine=False), dict(window_size=2),
                 dict(contact_format="dense"), dict(d_max=7)):
        assert campaign_lib.spec_hash(replace(cfg, **knob), (0, 1), SIG) == h, knob
    assert "device" in campaign_lib.NON_SEMANTIC_FIELDS
    for change in (dict(overlap="delayed"), dict(lr=0.2), dict(num_vehicles=7)):
        assert campaign_lib.spec_hash(replace(cfg, **change), (0, 1), SIG) != h
    assert campaign_lib.spec_hash(cfg, (0, 2), SIG) != h


def test_default_store_is_the_ports_own():
    assert common.default_store("smoke") == "results/campaign_smoke_torch.jsonl"
    assert campaign_lib.CampaignSpec().store_path == "results/campaign_smoke_torch.jsonl"
    spec = common.campaign_spec("smoke")
    assert spec.store_path == "results/campaign_smoke_torch.jsonl"
    assert spec.results_md is None and spec.base.device == "cuda"


# --------------------------------------------------------------------- store

def test_results_store_roundtrip_last_wins_and_torn_lines(tmp_path):
    store = ResultsStore(str(tmp_path / "s.jsonl"))
    store.append({"spec_hash": "aaaa", "v": 1})
    store.append({"spec_hash": "bbbb", "v": 2})
    store.append({"spec_hash": "aaaa", "v": 3})
    fresh = ResultsStore(str(tmp_path / "s.jsonl"))
    assert len(fresh) == 2 and "aaaa" in fresh and fresh.get("aaaa")["v"] == 3
    with pytest.raises(ValueError):
        store.append({"v": 1})
    path = tmp_path / "torn.jsonl"
    path.write_text('{"spec_hash": "good", "v": 1}\n{"spec_hash": "to')
    with pytest.warns(UserWarning, match="malformed"):
        assert list(ResultsStore(str(path)).load()) == ["good"]
    out = jsonable({"a": np.float32(1.5), "b": np.arange(3), "c": (np.int64(2),)})
    assert json.dumps(out) and out == {"a": 1.5, "b": [0, 1, 2], "c": [2]}


@pytest.fixture(scope="module")
def campaign_run(tmp_path_factory):
    """One tiny campaign (fig_overlap: dds sync + dds@delayed) into a store."""
    tmp = tmp_path_factory.mktemp("campaign")
    ds = synthetic_mnist(n_train=900, n_test=150)
    spec = campaign_lib.CampaignSpec(
        name="tiny", figures=("fig_overlap",), seeds=(0, 1),
        base=_tiny(eval_every=1), dataset_factory=lambda name: ds,
        store_path=str(tmp / "store.jsonl"), results_md=str(tmp / "R.md"))
    return spec, campaign_lib.run_campaign(spec)


def test_campaign_rows_round_trip_and_report(campaign_run):
    spec, results = campaign_run
    (fr,) = results
    assert [r["key"][3] for r in fr.scenario_rows] == ["dds", "dds@delayed"]
    stored = ResultsStore(spec.store_path).load()
    assert len(stored) == 2
    for row in fr.scenario_rows:
        assert stored[row["spec_hash"]]["kl_trace"] == row["kl_trace"]
        assert row["engine"]["device"] == "cpu"
        assert row["engine"]["path"] == "run_sweep/run_seeds"
        assert len(row["avg_accuracy"]) == 2 and np.isfinite(row["final_accuracy"]).all()
    assert fr.scenario_rows[1]["config"]["overlap"] == "delayed"
    assert [c.name for c in fr.checks] == ["delayed_learns", "delayed_within_tol_of_sync"]
    md = Path(spec.results_md).read_text()
    assert "repro_torch.figures.run" in md and "device=`cpu`" in md
    assert md == report_lib.render_results(spec, results)


def test_second_campaign_is_a_cache_hit(campaign_run, monkeypatch):
    spec, results = campaign_run

    def boom(*a, **k):
        raise AssertionError("a cached scenario was recomputed")

    monkeypatch.setattr(sweep_lib, "run_sweep", boom)
    again = campaign_lib.run_campaign(replace(spec, results_md=None))
    assert [r["spec_hash"] for r in again[0].scenario_rows] == \
        [r["spec_hash"] for r in results[0].scenario_rows]
    assert again[0].table == results[0].table


# ----------------------------------------------------------------------- CLIs

def _run(args):
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                          timeout=600)


def test_figures_cli_one_figure_on_the_cpu(tmp_path):
    store = tmp_path / "s.jsonl"
    out = _run(["repro_torch.figures.run", "--campaign", "smoke", "--device", "cpu",
                "--figures", "fig_overlap", "--seeds", "0", "--vehicles", "5",
                "--epochs", "2", "--store", str(store)])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ordering checks passed" in out.stdout and "results_md=None" in out.stdout
    assert len(ResultsStore(str(store))) == 2
    assert not (ROOT / "results" / "campaign_smoke_torch.jsonl").exists()


def test_cli_device_cuda_without_a_card_raises(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = _run(["repro_torch.figures.run", "--figures", "fig_overlap", "--seeds", "0",
                "--vehicles", "5", "--epochs", "2", "--store", str(tmp_path / "s.jsonl")])
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep_lib.main(["--vehicles", "4", "--epochs", "1"])


def test_sweep_cli_on_the_cpu():
    rows = sweep_lib.main(["--device", "cpu", "--algorithms", "dds", "dfl", "--seeds", "0",
                           "1", "--vehicles", "5", "--epochs", "2", "--eval-every", "2",
                           "--local-steps", "1", "--batch-size", "8", "--p1-steps", "10",
                           "--mixing-backend", "torch"])
    assert rows[0].startswith("road_net,distribution,algorithm,seeds")
    assert [r.split(",")[2] for r in rows[1:]] == ["dds", "dfl"]
    assert all(r.split(",")[3] == "2" for r in rows[1:])


# ----------------------------------------------------------------- registries

def test_registries_match_the_reference_by_name():
    ours, theirs = registries.registry_entries(), ref_registries.registry_entries()
    assert list(ours) == list(theirs)
    for title in ("algorithms", "road networks", "mobility models", "contact formats",
                  "execution backends"):
        assert [n for n, _ in ours[title]] == [n for n, _ in theirs[title]], title
    assert [n for n, _ in ours["execution backends"]] == ["shard_map", "vmap"]
    assert [n for n, _ in ours["campaign figures"]] == [n for n, _ in theirs["campaign figures"]]
    assert all(summary for _, summary in ours["campaign figures"])
    md = registries.render_markdown()
    assert md.startswith(registries.BEGIN_MARK) and md.endswith(registries.END_MARK)
    assert "`fig_overlap`" in md and "`dds`" in md and "`vmap`" in md
