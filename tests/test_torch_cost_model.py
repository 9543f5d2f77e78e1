"""The port's cost model (``repro_torch.roofline``) against the reference's
(``repro.roofline``), and ``execution="auto"`` in the port's engine.

* The closed form: under ``CI_HOST`` (kept verbatim in the port), with the
  same local-train statistics injected into both packages, every term of
  ``predict_scenario`` equals the reference's to rel 1e-12 over a grid of
  algorithm x contact format x backend x device count x bucket size x K.
* ``resolve_auto`` makes the reference's picks in the reference's own three
  cases (``tests/test_scenario_cost.py``), ``pallas``/``jnp`` read as
  ``cuda``/``torch``; the replays of the committed BENCH_*.json give the
  reference's rows.
* The local-train count (``flop_cost`` through ``FlopCounterMode``) is the
  CNNs' arithmetic, held to a closed-form count of their products.
* ``bench_schema`` is the reference's, message for message.
* A tiny ``execution="auto"`` federation on the CPU stamps its plan and
  follows the manual run's trajectory; two gloo ranks resolve one plan.
"""
import copy
import json
import os
import pickle
import time
from dataclasses import fields, replace
from pathlib import Path

import numpy as np
import pytest
import torch.multiprocessing as mp

from repro.fed import engine as ref_engine
from repro.roofline import bench_schema as ref_schema
from repro.roofline import scenario_cost as ref_sc
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.fed import engine
from repro_torch.launch import mesh as mesh_lib
from repro_torch.roofline import bench_schema, flop_cost, hw, scenario_cost as sc

ROOT = Path(__file__).resolve().parent.parent
# the port's mixing backends against the reference's
MIXING = {"cuda": "pallas", "torch": "jnp"}


@pytest.fixture(scope="module")
def ref_stats():
    """The reference's HLO-counted local-train statistics (E=1) for the
    batch sizes of its benchmark workloads: B=4 (BENCH_engine.json) and B=1
    (BENCH_scale.json)."""
    return {b: ref_sc.local_train_stats("mnist", 1, b) for b in (1, 4)}


@pytest.fixture
def injected(monkeypatch, ref_stats):
    """Both packages predict with the reference's statistics."""
    def stats(dataset, local_steps, batch_size):
        assert local_steps == 1 and dataset == "mnist"
        return ref_stats[batch_size]
    monkeypatch.setattr(ref_sc, "local_train_stats", stats)
    monkeypatch.setattr(sc, "local_train_stats", stats)


@pytest.fixture(scope="module")
def reports():
    return (bench_schema.load_engine_report(str(ROOT / "BENCH_engine.json")),
            bench_schema.load_scale_report(str(ROOT / "BENCH_scale.json")),
            bench_schema.load_collective_report(str(ROOT / "BENCH_collective.json")))


def _ref_profile(host: sc.HostProfile) -> ref_sc.HostProfile:
    """The reference's HostProfile with the port profile's constants."""
    kw = {f.name: getattr(host, f.name) for f in fields(host)
          if f.name not in ("p1_step_host_s", "p1_kernel_step_s",
                            "contact_host_s_per_vehicle", "contact_host_s_per_pair")}
    kw["pallas_mix_gain"] = kw.pop("cuda_mix_gain")
    return ref_sc.HostProfile(**kw)


def _pair(kw: dict, mixing: str = "cuda"):
    """The same configuration in both packages (port device: the CPU)."""
    port = engine.SimulationConfig(mixing_backend=mixing, device="cpu", **kw)
    ref = ref_engine.SimulationConfig(mixing_backend=MIXING[mixing], **kw)
    return port, ref


def _assert_same_breakdown(got: sc.CostBreakdown, want, rel=1e-12):
    assert got.terms.keys() == want.terms.keys()
    for name in want.terms:
        assert got.terms[name] == pytest.approx(want.terms[name], rel=rel, abs=0), name
    assert (got.d_max, got.num_shards, got.device_count) == (
        want.d_max, want.num_shards, want.device_count)
    assert got.epochs_per_s == pytest.approx(want.epochs_per_s, rel=rel)


# ---------------------------------------------------------- closed form ----

D_MAX = {8: 7, 64: 12, 1024: 11}     # the committed BENCH_scale.json budgets


@pytest.mark.parametrize("k", (8, 64, 1024))
@pytest.mark.parametrize("bucket_mb", (0.0, 4.0))
@pytest.mark.parametrize("devices", (1, 4))
@pytest.mark.parametrize("backend", ("vmap", "shard_map"))
@pytest.mark.parametrize("fmt", ("sparse", "dense"))
@pytest.mark.parametrize("algorithm", ("dds", "dfl"))
def test_closed_form_equals_reference_term_by_term(injected, algorithm, fmt, backend,
                                                   devices, bucket_mb, k):
    port, ref = _pair(dict(algorithm=algorithm, num_vehicles=k, epochs=8,
                           eval_every=4, eval_samples=100, local_steps=1,
                           batch_size=4, p1_steps=40, contact_format=fmt,
                           backend=backend, comm_bucket_mb=bucket_mb, d_max=D_MAX[k]))
    got = sc.predict_scenario(port, d_max=D_MAX[k], device_count=devices, host=sc.CI_HOST)
    want = ref_sc.predict_scenario(ref, d_max=D_MAX[k], device_count=devices,
                                   host=ref_sc.CI_HOST)
    _assert_same_breakdown(got, want)


def test_ci_host_is_the_reference_profile():
    assert _ref_profile(sc.CI_HOST) == ref_sc.CI_HOST
    assert sc.CI_HOST.p1_step_host_s == 0.0 == sc.CI_HOST.p1_kernel_step_s
    assert sc.default_host_profile("cpu") is sc.CI_HOST
    assert sc.default_host_profile("cuda") is sc.H100
    assert sc.default_host_profile("cuda:1") is sc.H100


@pytest.mark.parametrize("k", (8, 100, 1024))
@pytest.mark.parametrize("fmt", ("sparse", "dense"))
def test_h100_constants_without_the_host_terms_equal_the_reference(injected, fmt, k):
    """With the four constants the reference lacks at 0 the port's form is the
    reference's for any constants: the H100's, moved into a reference
    ``HostProfile``."""
    host = replace(sc.H100, p1_step_host_s=0.0, p1_kernel_step_s=0.0,
                   contact_host_s_per_vehicle=0.0, contact_host_s_per_pair=0.0)
    port, ref = _pair(dict(num_vehicles=k, epochs=4, eval_every=2, local_steps=1,
                           batch_size=4, contact_format=fmt, d_max=9))
    for mixing in ("cuda", "torch"):
        got = sc.predict_scenario(replace(port, mixing_backend=mixing), d_max=9, host=host)
        want = ref_sc.predict_scenario(replace(ref, mixing_backend=MIXING[mixing]),
                                       d_max=9, host=_ref_profile(host))
        _assert_same_breakdown(got, want)


@pytest.mark.parametrize("k,blocks", [(100, 1), (256, 1), (257, 2), (1024, 4)])
@pytest.mark.parametrize("fmt", ("sparse", "dense"))
def test_p1_step_host_s_is_a_floor_per_step_and_block(injected, fmt, k, blocks):
    """On the eager route (no one-launch solve: ``p1_kernel_step_s`` 0) each EG
    step costs max(host floor, the reference's step); the sparse solve pays
    the floor once per row block of ``P1_BLOCK`` vehicles (one eager loop
    each), the dense solve once."""
    from repro_torch.core import kl_solver
    assert kl_solver.P1_BLOCK == 256
    c = replace(sc.bench_engine_config(8), num_vehicles=k, device="cpu", contact_format=fmt)
    eager_host = replace(sc.H100, p1_kernel_step_s=0.0)
    bare_host = replace(eager_host, p1_step_host_s=0.0)
    bare = sc.predict_scenario(c, d_max=9, host=bare_host)
    floor = sc.predict_scenario(c, d_max=9, host=eager_host)
    per_step = (blocks if fmt == "sparse" else 1) * sc.H100.p1_step_host_s
    assert floor.terms["p1"] == pytest.approx(
        c.p1_steps * max(bare.terms["p1"] / c.p1_steps, per_step), rel=1e-12)
    assert floor.terms["p1"] >= bare.terms["p1"]
    assert {n: v for n, v in floor.terms.items() if n != "p1"} == {
        n: v for n, v in bare.terms.items() if n != "p1"}


@pytest.mark.parametrize("k,fmt,d_max,waves", [(100, "sparse", 11, 1), (100, "dense", 9, 1),
                                               (234, "dense", 9, 2), (1024, "sparse", 10, 4),
                                               (1024, "sparse", 46, 8), (1024, "sparse", 47, None),
                                               (235, "dense", 9, None), (1024, "dense", 9, None)])
def test_p1_kernel_route_where_the_states_fit_one_block(injected, k, fmt, d_max, waves):
    """On the H100 profile P1 is ``p1_steps`` one-launch steps a wave where a
    vehicle's ``[width, K]`` states fit one block of ``eg_solve`` (no host
    floor), else the eager route's form; every other term is unchanged."""
    c = replace(sc.bench_engine_config(8), num_vehicles=k, device="cpu", contact_format=fmt)
    width = k if fmt == "dense" else d_max
    assert sc.eg_solve_waves(k, width) == waves
    got = sc.predict_scenario(c, d_max=d_max, host=sc.H100)
    eager = sc.predict_scenario(c, d_max=d_max, host=replace(sc.H100, p1_kernel_step_s=0.0))
    if waves is None:
        assert got.terms == eager.terms
    else:
        assert got.terms["p1"] == pytest.approx(c.p1_steps * sc.H100.p1_kernel_step_s * waves,
                                                rel=1e-12)
        assert got.terms["p1"] < eager.terms["p1"]
        assert {n: v for n, v in got.terms.items() if n != "p1"} == {
            n: v for n, v in eager.terms.items() if n != "p1"}


def test_eg_solve_block_bytes_mirrors_the_kernel_source():
    """The mirror of ``solve_smem_bytes`` at the shapes that set the limits:
    the largest square state matrix is 234 (``eg_solve_max_k`` on an H100),
    and at K = 1,024 up to 46 neighbour slots fit."""
    limit = sc.hw.SMEM_BYTES_PER_BLOCK
    assert sc.eg_solve_block_bytes(234, 234) <= limit < sc.eg_solve_block_bytes(235, 235)
    assert sc.eg_solve_block_bytes(46, 1024) <= limit < sc.eg_solve_block_bytes(47, 1024)
    # u partial sums and r, log g over K = 100; alpha and 8 grad slices over
    # D = 11 (pitch 12); S [11, 100] at pitch 100 (25 chunks, odd)
    assert sc.eg_solve_block_bytes(11, 100) == 4 * (10 * 100 + 9 * 12 + 11 * 100)


def test_contact_host_cost_scales_the_overhead_with_the_fleet(injected):
    for k in (8, 1024):
        c = replace(sc.bench_engine_config(8), num_vehicles=k, device="cpu")
        got = sc.predict_scenario(c, d_max=9, host=sc.H100).terms["overhead"]
        assert got == pytest.approx(sc.H100.epoch_overhead_s
                                    + k * sc.H100.contact_host_s_per_vehicle
                                    + k * k * sc.H100.contact_host_s_per_pair, rel=1e-12)
    assert sc.H100.contact_host_s_per_vehicle > 0 == sc.CI_HOST.contact_host_s_per_vehicle
    assert sc.H100.contact_host_s_per_pair > 0 == sc.CI_HOST.contact_host_s_per_pair


def test_breakdown_terms_positive_and_jsonable(injected):
    cfg = replace(sc.bench_engine_config(8), backend="shard_map", device="cpu")
    bd = sc.predict_scenario(cfg, d_max=3, device_count=4)
    assert bd.num_shards == 4 and "collective" in bd.terms
    assert all(v >= 0 for v in bd.terms.values())
    assert bd.total_s == pytest.approx(sum(bd.terms.values()))
    json.dumps(bd.jsonable())


# ------------------------------------------------------ execution = "auto" ----

def _resolved(cfg) -> tuple:
    return (cfg.execution, cfg.backend, cfg.contact_format, cfg.d_max)


def test_auto_picks_as_the_reference_k8(reports):
    """The reference's K=8 case: its engine workload, the device count the
    benchmark recorded."""
    devices = int(reports[0]["device_count"])
    port = replace(sc.bench_engine_config(8), execution="auto", mixing_backend="torch",
                   device="cpu")
    ref = replace(ref_sc.bench_engine_config(8), execution="auto")
    got, plan = sc.resolve_auto(port, device_count=devices, host=sc.CI_HOST)
    want, ref_plan = ref_sc.resolve_auto(ref, device_count=devices)
    assert _resolved(got) == _resolved(want)
    assert MIXING[got.mixing_backend] == want.mixing_backend
    assert plan["resolved"] == {**ref_plan["resolved"],
                                "mixing_backend": got.mixing_backend}
    assert len(plan["candidates"]) == len(ref_plan["candidates"]) >= 4
    json.dumps(plan)


def test_auto_picks_as_the_reference_k1024(reports):
    """The reference's K=1024 case: the recorded D_max pinned, one device."""
    scale = reports[1]
    pair = next(r for r in scale["sparse_vs_dense"] if r["num_vehicles"] == 1024)
    epochs = next(r["epochs"] for r in scale["results"] if r["num_vehicles"] == 1024)
    want, ref_plan = ref_sc.resolve_auto(replace(
        ref_sc.bench_scale_config(1024, "dense", epochs, d_max=pair["d_max"]),
        execution="auto"), device_count=1)
    got, plan = sc.resolve_auto(replace(
        sc.bench_scale_config(1024, "dense", epochs, d_max=pair["d_max"]),
        execution="auto", mixing_backend="torch"), device_count=1, host=sc.CI_HOST)
    assert _resolved(got) == _resolved(want)
    assert got.backend == "vmap" and plan["resolved"]["d_max"] == pair["d_max"]


def test_auto_picks_as_the_reference_with_a_density():
    kw = dict(execution="auto", contact_density=0.5)
    want, ref_plan = ref_sc.resolve_auto(replace(ref_sc.bench_engine_config(8), **kw),
                                         device_count=1)
    got, plan = sc.resolve_auto(replace(sc.bench_engine_config(8), **kw),
                                device_count=1, host=sc.CI_HOST)
    assert _resolved(got) == _resolved(want)
    assert plan["resolved"]["d_max"] == ref_plan["resolved"]["d_max"] == 4


def test_h100_adds_the_cuda_mix_as_a_candidate():
    """``enumerate_candidates`` adds ``"cuda"`` where the reference adds
    ``"pallas"``: when the profile's kernel gain exceeds 1."""
    cfg = replace(sc.bench_engine_config(8), mixing_backend="torch")
    assert sc.H100.cuda_mix_gain > 1.0
    mixings = {c.mixing_backend for c in sc.enumerate_candidates(cfg, 1, sc.H100)}
    assert mixings == {"torch", "cuda"}
    assert {c.mixing_backend for c in sc.enumerate_candidates(cfg, 1, sc.CI_HOST)} == {"torch"}


def test_resolve_auto_counts_the_ranks_of_the_process_group(monkeypatch):
    monkeypatch.setattr(mesh_lib, "world_size", lambda: 4)
    cfg = replace(sc.bench_engine_config(8), execution="auto", contact_density=0.5,
                  device="cpu")
    _, plan = sc.resolve_auto(cfg)
    assert plan["device_count"] == 4 and plan["host_profile"] == "ci_host"
    assert {c["backend"] for c in plan["candidates"]} == {"vmap", "shard_map"}


# --------------------------------------------------------------- replays ----

def test_replays_give_the_reference_rows(injected, reports):
    engine_report, scale_report, _ = reports
    got = sc.replay_bench_engine(engine_report) + sc.replay_bench_scale(scale_report)
    want = (ref_sc.replay_bench_engine(engine_report)
            + ref_sc.replay_bench_scale(scale_report))
    assert len(got) == len(want) == len(engine_report["results"]) + 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["pair"] == w["pair"]
        for key in ("measured_ratio", "predicted_ratio", "predicted_a", "predicted_b"):
            assert abs(g[key] - w[key]) <= 1e-9, (g, w)
        assert g["verdict"] == w["verdict"] != "MISMATCH"
    table = sc.predicted_vs_measured_table(got[:2], got[2:])
    assert table == ref_sc.predicted_vs_measured_table(want[:2], want[2:])


def test_replays_with_the_ports_own_count_have_no_mismatch(reports):
    engine_report, scale_report, _ = reports
    rows = sc.replay_bench_engine(engine_report) + sc.replay_bench_scale(scale_report)
    assert [r["verdict"] for r in rows if r["verdict"] == "MISMATCH"] == []


def test_cli_writes_the_table(tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    out = tmp_path / "table.md"
    assert sc.main(["--out", str(out)]) == 0
    assert "sparse-vs-dense K=1024" in out.read_text()
    assert "MISMATCH" not in out.read_text()


@pytest.mark.parametrize("measured,predicted,verdict", [
    (2.0, 1.5, "ok"), (2.0, 0.8, "MISMATCH"), (0.5, 0.9, "ok"),
    (1.05, 0.9, "tie-ok"), (1.05, 3.0, "MISMATCH")])
def test_ranking_verdict_bands(measured, predicted, verdict):
    assert sc.ranking_verdict(measured, predicted) == verdict
    assert ref_sc.ranking_verdict(measured, predicted) == verdict


# ------------------------------------------------------------ flop count ----

def _cnn_products(kind: str) -> tuple[int, int]:
    """(multiply-adds of one sample's forward, those of the first layer) of
    the paper's CNN, counted by hand: every convolution and dense layer is
    one product (out positions x out channels x kernel volume)."""
    if kind == "mnist":
        layers = [24 * 24 * 10 * 5 * 5 * 1, 8 * 8 * 20 * 5 * 5 * 10, 320 * 50, 50 * 10]
    else:
        layers = [32 * 32 * 16 * 3 * 3 * 3, 16 * 16 * 32 * 3 * 3 * 16,
                  8 * 8 * 64 * 3 * 3 * 32, 1024 * 10]
    return sum(layers), layers[0]


@pytest.mark.parametrize("kind,params,flops", [("mnist", 21_840, 1_660_800_000),
                                               ("cifar10", 33_834, 10_231_480_320)])
def test_local_train_stats_counts_the_cnns_products(kind, params, flops):
    """E=8, B=80: forward 2 flops per multiply-add; backward the weight and
    input gradients of every product, except the first layer's input
    gradient, which nothing needs."""
    s = sc.local_train_stats(kind, 8, 80)
    assert (s["params"], s["leaves"]) == (params, 8)
    macs, first = _cnn_products(kind)
    per_sample = 3 * 2 * macs - 2 * first
    assert s["flops"] == flops == 8 * 80 * per_sample
    assert s["traffic_bytes"] > 4 * params * 8


def test_local_train_stats_e2_doubles_e1():
    one, two = sc.local_train_stats("mnist", 1, 1), sc.local_train_stats("mnist", 2, 1)
    assert two["flops"] == 2 * one["flops"]
    assert two["params"] == one["params"] == 21_840


@pytest.mark.parametrize("kind,ratio", [("mnist", 0.4387), ("cifar10", 0.8653)])
def test_reference_hlo_count_includes_patch_convolutions(kind, ratio):
    """The reference counts the compiled HLO (``hlo_cost``), and its CNN
    extracts patches with ``jax.lax.conv_general_dilated_patches``, which
    XLA lowers to convolutions with a one-hot kernel (forward, plus their
    transposes in the backward pass). ``hlo_cost`` counts those as
    arithmetic; its ``dot`` flops equal the port's count exactly (checked
    with ``hlo_cost.HloCostModel`` per computation: MNIST 207.6 MFLOP of
    dots and 265.6 MFLOP of patch convolutions per step of B=80). The port's
    ``F.unfold`` is data movement and counts nothing, so the port counts
    0.4387x (MNIST) / 0.8653x (CIFAR-10) of the reference's flops. Each
    package's profiles are fitted against its own count."""
    port = sc.local_train_stats(kind, 8, 80)
    ref = ref_sc.local_train_stats(kind, 8, 80)
    assert (port["params"], port["leaves"]) == (ref["params"], ref["leaves"])
    assert port["flops"] / ref["flops"] == pytest.approx(ratio, abs=1e-3)


def test_analyze_fn_counts_a_product_and_its_bytes():
    import torch
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    got = flop_cost.analyze_fn(torch.matmul, a, b)
    assert got["flops_per_device"] == 2 * 8 * 16 * 4
    assert got["traffic_bytes_per_device"] == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    # a view moves nothing
    assert flop_cost.analyze_fn(lambda t: t.t(), a)["traffic_bytes_per_device"] == 0
    # the meta device: shapes only
    meta = flop_cost.analyze_fn(torch.matmul, a.to("meta"), b.to("meta"))
    assert meta == got


def test_h100_constants_are_the_published_ones():
    assert (hw.F32_FLOP_PER_S, hw.TF32_FLOP_PER_S, hw.BF16_FLOP_PER_S) == (67e12, 495e12, 989e12)
    assert (hw.HBM_BYTES_PER_S, hw.HBM_BYTES) == (3.35e12, 80 * 2**30)
    assert (hw.SMS, hw.SMEM_BYTES_PER_SM, hw.NVLINK_BYTES_PER_S) == (132, 228 * 1024, 900e9)


# ---------------------------------------------------------------- schema ----

def _drop_row(report, pred):
    report["results"] = [r for r in report["results"] if not pred(r)]


def _set(path_fn, key, value):
    def edit(report):
        path_fn(report)[key] = value
    return edit


def _del(path_fn, key):
    def edit(report):
        del path_fn(report)[key]
    return edit


def _first(report):
    return report["results"][0]


def _first_sparse(report):
    return next(r for r in report["results"] if r["contact_format"] == "sparse")


# the malformed cases of tests/test_bench_schema.py: (report, edit, message)
MALFORMED = {
    "engine_missing_key": (0, _del(_first, "vmap_epochs_per_s"), "vmap_epochs_per_s"),
    "engine_wrong_type": (0, _set(_first, "num_vehicles", "8"), "num_vehicles"),
    "engine_inconsistent_ratio": (0, _set(_first, "shard_vs_vmap", 99.0), "inconsistent"),
    "engine_nonpositive_rate": (0, _set(_first, "vmap_epochs_per_s", 0.0), "out of range"),
    "engine_wrong_benchmark_name": (0, _set(lambda r: r, "benchmark", "something_else"),
                                    "expected benchmark"),
    "scale_missing_cell": (1, lambda r: _drop_row(r, lambda c: c["num_vehicles"] == 64
                                                  and c["contact_format"] == "dense"),
                           "missing the dense cell"),
    "scale_sparse_without_d_max": (1, _set(_first_sparse, "d_max", 0), "d_max"),
    "scale_unknown_format": (1, _set(_first, "contact_format", "csr"), "contact_format"),
    "collective_missing_derived_key": (2, _del(lambda r: r["derived"], "overlap_fraction"),
                                       "overlap_fraction"),
    "collective_overlap_out_of_range": (2, _set(lambda r: r["derived"], "overlap_fraction",
                                                1.5), "overlap_fraction"),
    "collective_unknown_name": (2, _set(_first, "collective", "all_to_all"), "collective"),
    "collective_missing_bucketed_rows": (2, lambda r: _drop_row(
        r, lambda c: c["collective"] == "psum_scatter_bucketed"), "psum_scatter_bucketed"),
    "collective_bool_derived": (2, _set(lambda r: r["derived"], "overlap_fraction", True),
                                "overlap_fraction"),
    "collective_nonpositive_rate": (2, _set(_first, "gbytes_per_s", 0.0), "out of range"),
    "empty_results": (0, _set(lambda r: r, "results", []), "non-empty"),
    "bool_is_not_an_int": (0, _set(_first, "epochs", True), "epochs"),
}
VALIDATORS = ("validate_engine_report", "validate_scale_report", "validate_collective_report")


def test_schema_accepts_the_committed_reports(reports):
    for name, report in zip(VALIDATORS, reports):
        assert getattr(bench_schema, name)(copy.deepcopy(report)) == report
        json.dumps(report)


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_schema_rejects_malformed_reports_as_the_reference(reports, case):
    which, edit, message = MALFORMED[case]
    bad = copy.deepcopy(reports[which])
    edit(bad)
    with pytest.raises(bench_schema.BenchSchemaError, match=message) as got:
        getattr(bench_schema, VALIDATORS[which])(copy.deepcopy(bad))
    with pytest.raises(ref_schema.BenchSchemaError) as want:
        getattr(ref_schema, VALIDATORS[which])(copy.deepcopy(bad))
    assert str(got.value) == str(want.value)


# ------------------------------------------------------ engine, the CPU ----

BASE = dict(num_vehicles=6, epochs=4, eval_every=2, eval_samples=60, local_steps=1,
            batch_size=4, p1_steps=10)


@pytest.fixture(scope="module")
def tiny_runs():
    """``execution="auto"`` and manual ``run_seeds`` on the CPU, the reference
    resolving the same configuration."""
    ds = synthetic_mnist(n_train=600, n_test=120)
    cfg = engine.SimulationConfig(device="cpu", execution="auto", **BASE)
    auto = engine.run_seeds(cfg, [0, 1], dataset=ds)
    manual = engine.run_seeds(replace(cfg, execution="manual"), [0, 1], dataset=ds)
    ref_cfg, ref_plan = ref_engine.resolve_execution(
        ref_engine.SimulationConfig(execution="auto", **BASE))
    return auto, manual, ref_cfg, ref_plan


def test_auto_run_seeds_stamps_the_plan(tiny_runs):
    auto, manual, _, _ = tiny_runs
    assert len(auto) == 2
    for r in auto:
        plan = r.execution_plan
        assert plan["requested"] == "auto" and plan["host_profile"] == "ci_host"
        assert r.config.execution == "manual"
        assert r.config.backend in ("vmap", "shard_map")
        assert r.config.contact_format in ("sparse", "dense")
        assert plan["resolved"]["contact_format"] == r.config.contact_format
        json.dumps(plan)
    assert all(r.execution_plan is None for r in manual)


def test_auto_follows_the_manual_trajectory(tiny_runs):
    auto, manual, _, _ = tiny_runs
    for a, m in zip(auto, manual):
        np.testing.assert_allclose(a.avg_accuracy, m.avg_accuracy, atol=1e-5)
        np.testing.assert_allclose(a.kl_trace, m.kl_trace, atol=1e-5)
        np.testing.assert_allclose(a.comm_mb, m.comm_mb, atol=1e-5)


def test_auto_plan_picks_the_references_knobs(tiny_runs):
    auto, _, ref_cfg, ref_plan = tiny_runs
    got = auto[0].config
    assert (got.backend, got.contact_format, got.d_max) == (
        ref_cfg.backend, ref_cfg.contact_format, ref_cfg.d_max)
    assert auto[0].execution_plan["resolved"]["d_max"] == ref_plan["resolved"]["d_max"]


def test_run_simulation_and_the_legacy_loop_stamp_the_plan():
    ds = synthetic_mnist(n_train=300, n_test=60)
    cfg = engine.SimulationConfig(device="cpu", execution="auto",
                                  **{**BASE, "epochs": 2})
    from repro_torch.fed.simulator import run_simulation
    scan = run_simulation(cfg, dataset=ds)
    loop = run_simulation(replace(cfg, use_scan_engine=False), dataset=ds)
    assert scan.execution_plan == loop.execution_plan is not None
    assert scan.config.execution == loop.config.execution == "manual"
    np.testing.assert_allclose(scan.avg_accuracy, loop.avg_accuracy, atol=1e-5)
    ctx = engine.build_context(cfg, dataset=ds)
    assert ctx.execution_plan == scan.execution_plan and ctx.cfg.execution == "manual"


def test_sweep_cli_resolves_auto(capsys):
    from repro_torch.launch import sweep
    rows = sweep.main(["--device", "cpu", "--execution", "auto", "--algorithms", "dds",
                       "--vehicles", "6", "--epochs", "2", "--eval-every", "1",
                       "--local-steps", "1", "--batch-size", "4", "--p1-steps", "5"])
    assert rows[0].startswith("road_net,") and len(rows) == 2


# ---------------------------------------------------- two gloo ranks ----

RANK_CFG = dict(num_vehicles=8, epochs=2, eval_every=2, eval_samples=40, local_steps=1,
                batch_size=4, p1_steps=5, comm_range=250.0, device="cpu",
                execution="auto")


def _rank_main(rank: int, n: int, out_dir: str) -> None:
    """One rank: resolve the auto config and run it; writes the plan and the
    trajectory to ``out_dir/rank{rank}.pkl``."""
    import torch
    torch.set_num_threads(1)
    mesh_lib.initialize_multihost(
        init_method=f"file://{os.path.join(out_dir, 'store')}", num_processes=n,
        process_id=rank, transport="gloo")
    try:
        cfg = engine.SimulationConfig(**RANK_CFG)
        _, plan = engine.resolve_execution(cfg)
        from repro_torch.fed.simulator import run_simulation
        res = run_simulation(cfg, dataset=synthetic_mnist(n_train=400, n_test=40))
        out = {"plan": plan, "run_plan": res.execution_plan, "backend": res.config.backend,
               "kl_trace": res.kl_trace, "avg_accuracy": res.avg_accuracy}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        mesh_lib.shutdown()


def test_two_gloo_ranks_resolve_one_plan(tmp_path):
    """Spawned as ``tests/test_torch_sharded.py`` spawns its ranks: a
    ``FileStore`` under the test's temporary directory, no TCP port."""
    ctx = mp.start_processes(_rank_main, args=(2, str(tmp_path)), nprocs=2, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=1):
        assert time.monotonic() < deadline, "the ranks did not finish"
    outs = [pickle.load(open(tmp_path / f"rank{r}.pkl", "rb")) for r in range(2)]
    assert outs[0]["plan"] == outs[1]["plan"] == outs[0]["run_plan"] == outs[1]["run_plan"]
    assert outs[0]["plan"]["device_count"] == 2
    assert {c["backend"] for c in outs[0]["plan"]["candidates"]} == {"vmap", "shard_map"}
    assert outs[0]["backend"] == outs[1]["backend"] == outs[0]["plan"]["resolved"]["backend"]
    assert outs[0]["kl_trace"] == outs[1]["kl_trace"]
    assert outs[0]["avg_accuracy"] == outs[1]["avg_accuracy"]
