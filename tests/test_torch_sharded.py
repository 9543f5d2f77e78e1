"""The vehicle-sharded backend of the port (``backend="shard_map"`` over a
``torch.distributed`` group) against the port's vmap backend and the JAX
reference.

Two spawns compute every case: one of 2 gloo ranks and one of 4, on the CPU,
each rank a process of its own, meeting through a ``FileStore`` under the
test's temporary directory (no TCP port, so parallel test workers cannot
collide). Every rank writes what it computed to a file; the tests below read
those files. The spawned ranks import torch and ``repro_torch`` only; the
JAX reference runs in the test process.

Tolerances are the reference's (``tests/test_backends.py``): f32 atol 1e-5,
consensus distance rtol 1e-4 on top. The sharded and vmap runs use the
reference's parity configuration (K=8, 4 epochs, eval every 2, E=2, B=8,
30 P1 steps, lr 0.15; 120 eval samples where it takes 240, which halves the
evaluation that dominates these runs) plus a denser contact graph
(comm_range 250).
"""
import os
import pickle
import time
from dataclasses import replace

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.core import aggregation, contacts, vehicle_axis
from repro_torch.data import pipeline
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.fed import algorithms, backends, engine, simulator
from repro_torch.kernels.gossip_mix import mix_params_cuda
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import cnn
from repro_torch.profiling import PhaseTimer

T = torch.as_tensor
K = 8
FIELDS = ("avg_accuracy", "vehicle_accuracy", "entropy", "kl_divergence",
          "consensus_distance", "kl_trace", "comm_mb")
STATE_FIELDS = ("kl_trace", "comm_mb", "entropy", "kl_divergence")
CFG = dict(num_vehicles=K, epochs=4, eval_every=2, eval_samples=120, local_steps=2,
           batch_size=8, p1_steps=30, lr=0.15, seed=0, device="cpu")
DATA = dict(n_train=1200, n_test=120)
ALGORITHMS = ("dds", "dfl", "d_sgd", "d_fedavg", "sp")
FORMATS = ("sparse", "dense")

# every end-to-end case of the 2-rank spawn: config overrides
RUNS_2 = {f"{a}/{f}": dict(algorithm=a, contact_format=f)
          for a in ALGORITHMS for f in FORMATS}
RUNS_2.update({
    "dds/sparse/near": dict(comm_range=250.0),
    "dds/dense/near": dict(comm_range=250.0, contact_format="dense"),
    "dds/sparse/delayed": dict(overlap="delayed", comm_range=250.0),
    "dds/dense/delayed": dict(overlap="delayed", comm_range=250.0, contact_format="dense"),
    "d_fedavg/sparse/delayed": dict(algorithm="d_fedavg", overlap="delayed",
                                    comm_range=250.0),
    "dds/sparse/anchor": dict(overlap="delayed", p_drop=1.0, comm_range=250.0),
    "dds/sparse/per_leaf": dict(comm_bucket_mb=0.0, comm_range=250.0),
    "dds/sparse/buckets": dict(comm_bucket_mb=0.05, comm_range=250.0),
    "dds/dense/torch_mix": dict(mixing_backend="torch", contact_format="dense",
                                comm_range=250.0),
    "dds/sparse/progress": dict(comm_range=250.0),
})
RUNS_4 = {"dds/sparse": dict(comm_range=250.0),
          "dds/dense": dict(comm_range=250.0, contact_format="dense"),
          "sp/sparse": dict(algorithm="sp", comm_range=250.0)}
SEEDS = (0, 1)

# sharded_mix on numpy inputs: leaves of a few shapes, a bucket budget that
# packs them into at least two buckets at both rank counts
LEAF_SHAPES = {"a": (K, 3, 5), "b": (K, 7), "c": (K,), "d": (K, 40)}
SMALL_BUCKET_MB = 300 / 2**20
MIX_FNS = {"torch": aggregation.mix_params, "cuda_route": mix_params_cuda}


def _mix_inputs(seed: int = 0):
    r = np.random.default_rng(seed)
    c = np.triu(r.random((K, K)) < 0.5, 1)
    c = (c | c.T | np.eye(K, dtype=bool)).astype(np.float32)
    dense = c * r.random((K, K)).astype(np.float32)
    dense /= dense.sum(1, keepdims=True)
    d = int(c.sum(1).max()) + 2                     # two spare padding slots
    idx = np.tile(np.arange(K, dtype=np.int32)[:, None], (1, d))
    w = np.zeros((K, d), np.float32)
    for k in range(K):
        nbrs = np.nonzero(c[k])[0]
        idx[k, :len(nbrs)] = nbrs
        w[k, :len(nbrs)] = dense[k, nbrs]
    params = {n: r.normal(size=s).astype(np.float32) for n, s in LEAF_SHAPES.items()}
    return dense, idx, w, params


# ------------------------------------------------------------ the ranks ----

def _run(cfg_kw: dict, ds, backend: str = "shard_map", progress: bool = False):
    cfg = simulator.SimulationConfig(**{**CFG, **cfg_kw}, backend=backend)
    ctx = engine.build_context(cfg, dataset=ds)
    result = engine.run_with_context(ctx, progress=progress)
    return result, ctx


def _rank_main(rank: int, n: int, out_dir: str) -> None:
    """One rank: every case of an ``n``-rank spawn; writes its results to
    ``out_dir/rank{rank}.pkl``."""
    torch.set_num_threads(1)
    out = {}
    assert mesh_lib.initialize_multihost(
        init_method=f"file://{os.path.join(out_dir, 'store')}", num_processes=n,
        process_id=rank, transport="gloo") == n
    mesh = mesh_lib.make_multihost_federation_mesh()
    group = mesh.get_group("vehicle")
    out["mesh"] = dict(names=tuple(mesh.mesh_dim_names), shape=tuple(mesh.mesh.shape),
                       vehicle_axes=mesh_lib.vehicle_axes(mesh),
                       data_axes=mesh_lib.data_axes(mesh),
                       total=mesh_lib.total_devices(mesh),
                       vehicles=mesh_lib.num_vehicles(mesh, per_pod_vehicle=3),
                       group_size=torch.distributed.get_world_size(group),
                       transport=mesh_lib.transport())
    shard = backends.get_backend("shard_map").shard_for(
        simulator.SimulationConfig(**CFG), K)
    out["shard"] = (shard.rank, shard.num_shards, shard.staged)

    # sharded_mix on the same numpy inputs as the reference gets
    dense, idx, w, params = _mix_inputs()
    local = {name: shard.local_rows(T(x)) for name, x in params.items()}
    mixings = {"dense": T(dense), "sparse": contacts.SparseMixing(T(idx), T(w))}
    out["mix"] = {}
    for fmt, mixing in mixings.items():
        for fn_name, fn in MIX_FNS.items():
            for bucket_mb in (0.0, SMALL_BUCKET_MB):
                mixed = vehicle_axis.sharded_mix(fn, shard, bucket_mb)(mixing, local)
                out["mix"][(fmt, fn_name, bucket_mb > 0)] = {
                    name: shard.gather_rows(x).numpy() for name, x in mixed.items()}
    leaves = list(local.values())
    out["buckets"] = len(vehicle_axis.comm_buckets(leaves, SMALL_BUCKET_MB * 2**20))

    ds = synthetic_mnist(**DATA)
    runs = RUNS_2 if n == 2 else RUNS_4
    out["runs"] = {}
    for name, kw in runs.items():
        result, ctx = _run(kw, ds, progress=name.endswith("progress"))
        out["runs"][name] = result
        if name == "dds/sparse/near":
            final = ctx.final_state
            out["final_state"] = (final.state_matrix.numpy(),
                                  {p: x.numpy() for p, x in final.params.items()})
    if n == 2:
        cfg = simulator.SimulationConfig(**{**CFG, "comm_range": 250.0},
                                         backend="shard_map")
        out["seeds"] = engine.run_seeds(cfg, SEEDS, dataset=ds)
        timer = PhaseTimer("cpu")
        ctx = engine.build_context(cfg, dataset=ds, timer=timer)
        engine.run_with_context(ctx)
        out["phases"] = sorted(timer.totals_ms())
    # a fleet that does not divide over the ranks
    odd = K - 1 if n == 2 else 6
    try:
        _run(dict(num_vehicles=odd), ds)
        out["indivisible"] = None
    except ValueError as err:
        out["indivisible"] = str(err)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    mesh_lib.shutdown()


def _vmap_results() -> dict:
    ds = synthetic_mnist(**DATA)
    out = {}
    for name, kw in {**RUNS_2, **{f"n4:{k}": v for k, v in RUNS_4.items()}}.items():
        if name.endswith("anchor"):       # the W = I anchor: delayed vs SYNC
            kw = {k: v for k, v in kw.items() if k != "overlap"}
        out[name], ctx = _run(kw, ds, backend="vmap")
        if name == "dds/sparse/near":
            out["final_state"] = ctx.final_state
    cfg = simulator.SimulationConfig(**{**CFG, "comm_range": 250.0})
    out["seeds"] = engine.run_seeds(cfg, SEEDS, dataset=ds)
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both spawns started together; the vmap runs computed in this process
    meanwhile. Returns ({n: [rank outputs]}, vmap results)."""
    root = tmp_path_factory.mktemp("sharded")
    procs = {}
    for n in (2, 4):
        (root / f"n{n}").mkdir()
        procs[n] = mp.start_processes(_rank_main, args=(n, str(root / f"n{n}")),
                                      nprocs=n, join=False, start_method="spawn")
    vmap = _vmap_results()
    deadline = time.monotonic() + 300
    for n, ctx in procs.items():
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the {n}-rank spawn did not finish in time")
    ranks = {n: [pickle.loads((root / f"n{n}" / f"rank{r}.pkl").read_bytes())
                 for r in range(n)] for n in procs}
    return ranks, vmap


def _assert_same_run(got, want, atol=1e-5):
    assert got.epochs_evaluated == want.epochs_evaluated
    for f in FIELDS:
        rtol = 1e-4 if f == "consensus_distance" else 0.0
        np.testing.assert_allclose(np.asarray(getattr(got, f), float),
                                   np.asarray(getattr(want, f), float),
                                   atol=atol, rtol=rtol, err_msg=f)


# ------------------------------------------------ helpers vs the reference ----

def _ref_leaves(shapes, dtypes=None):
    import jax.numpy as jnp
    dtypes = dtypes or ["float32"] * len(shapes)
    return [jnp.ones(s, getattr(jnp, d)) for s, d in zip(shapes, dtypes)]


def _port_leaves(shapes, dtypes=None):
    dtypes = dtypes or ["float32"] * len(shapes)
    return [torch.ones(s, dtype=getattr(torch, d)) for s, d in zip(shapes, dtypes)]


BUCKET_CASES = {   # the cases of tests/test_vehicle_axis.py: shapes, dtypes, budget
    "exact_and_ordered": ([(K, 10), (K, 3), (K, 7, 2), (K,)], None, 4 * K * 12),
    "one_bucket": ([(K, 4)] * 5, None, 1e9),
    "per_leaf": ([(K, 4)] * 3, None, 1.0),
    "oversized_leaf": ([(K, 2), (K, 1000), (K, 2)], None, 4 * K * 8),
    "dtype_change": ([(K, 2), (K, 2), (K, 2)], ["float32", "float32", "bfloat16"], 1e9),
    "six_leaves": ([(K, 256)] * 6, None, 2 * 8192),
}


@pytest.mark.parametrize("case", list(BUCKET_CASES))
def test_comm_buckets_match_reference(case):
    from repro.core import vehicle_axis as ref_va
    shapes, dtypes, budget = BUCKET_CASES[case]
    got = vehicle_axis.comm_buckets(_port_leaves(shapes, dtypes), budget)
    assert got == ref_va.comm_buckets(_ref_leaves(shapes, dtypes), budget)
    assert [i for b in got for i in b] == list(range(len(shapes)))


@pytest.mark.parametrize("payload_mb,bucket_mb,leaves", [
    (10, 4.0, 8), (0.5, 4.0, 8), (100, 0.001, 3), (10, 0.0, 8), (10, -1.0, 5),
    (8.7, 4.0, 8), (4.37, 4.0, 8)])
def test_num_comm_buckets_matches_reference(payload_mb, bucket_mb, leaves):
    from repro.core import vehicle_axis as ref_va
    payload = payload_mb * 2**20
    assert (vehicle_axis.num_comm_buckets(payload, bucket_mb, leaves)
            == ref_va.num_comm_buckets(payload, bucket_mb, leaves))


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_psum_scatter_bytes_and_local_nodes_match_reference(num_shards):
    from repro.core import vehicle_axis as ref_va
    row_bytes = 21840 * 4
    assert (vehicle_axis.psum_scatter_bytes(100, row_bytes, num_shards)
            == ref_va.psum_scatter_bytes(100, row_bytes, num_shards))
    shard = vehicle_axis.VehicleSharding(group=object(), num_shards=num_shards)
    ref_shard = ref_va.VehicleSharding("vehicle", num_shards)
    assert vehicle_axis.local_nodes(100, shard) == ref_va.local_nodes(100, ref_shard)
    if num_shards > 1:
        with pytest.raises(ValueError):
            vehicle_axis.local_nodes(101, shard)
    # bucketing regroups collectives, never bytes
    leaves = _port_leaves([(K, 10), (K, 3), (K, 7, 2), (K,)])
    rows = [x.numel() // K * 4 for x in leaves]
    per_bucket = sum(vehicle_axis.psum_scatter_bytes(K, sum(rows[i] for i in b), num_shards)
                     for b in vehicle_axis.comm_buckets(leaves, 4 * K * 12))
    assert per_bucket == pytest.approx(vehicle_axis.psum_scatter_bytes(K, sum(rows), num_shards))


@pytest.mark.parametrize("ranks,total,max_shards", [
    (4, 7, None), (4, 13, None), (8, 12, 3), (8, 12, 5), (8, 16, 64), (8, 2, None),
    (8, 1, None), (4, 8, None), (4, 6, None), (2, 100, None), (4, 100, None)])
def test_vehicle_shards_matches_reference(monkeypatch, ranks, total, max_shards):
    from repro.fed import backends as ref_backends
    monkeypatch.setattr(ref_backends.jax, "device_count", lambda: ranks)
    monkeypatch.setattr(backends.mesh_lib, "world_size", lambda: ranks)
    assert (backends.vehicle_shards(total, max_shards)
            == ref_backends.vehicle_shards(total, max_shards))


# --------------------------------------------------- the pieces, in-process ----

def test_row_block_generator_draws_the_global_stream():
    """Each shard's dropout draw is its block of the global run's draw."""
    full = torch.rand((K, 5, 3), generator=torch.Generator().manual_seed(7))
    for n in (2, 4):
        blocks = [vehicle_axis.RowBlockGenerator(torch.Generator().manual_seed(7), r, n)
                  .rand_rows((K // n, 5, 3), "cpu") for r in range(n)]
        assert torch.equal(torch.cat(blocks), full)
    x = torch.ones(K // 2, 4, 50)
    shard = vehicle_axis.VehicleSharding(group=object(), rank=1, num_shards=2)
    got = cnn._dropout(x, 0.5, None, shard.local_generator(torch.Generator().manual_seed(3)),
                       True)
    want = cnn._dropout(torch.ones(K, 4, 50), 0.5, None,
                        torch.Generator().manual_seed(3), True)[K // 2:]
    assert torch.equal(got, want)
    assert vehicle_axis.GLOBAL.local_generator("g") == "g"


@pytest.mark.parametrize("full", [False, True])
def test_sliced_samplers_draw_at_global_k(full):
    ds = synthetic_mnist(n_train=400, n_test=10)
    table = np.arange(400).reshape(K, 50)
    data = pipeline.make_federated_data(ds.train_x, ds.train_y, table, np.full(K, 50))
    rows = slice(2, 4)
    if full:
        want = pipeline.sample_full_batches(data, torch.Generator().manual_seed(1), 16)
        got = pipeline.sample_full_batches_sliced(data, torch.Generator().manual_seed(1), 16,
                                                  take_rows=lambda t: t[rows])
    else:
        want = pipeline.sample_batches(data, torch.Generator().manual_seed(1), 3, 16)
        got = pipeline.sample_batches_sliced(data, torch.Generator().manual_seed(1), 3, 16,
                                             take_rows=lambda t: t[rows])
    assert torch.equal(got[0], want[0][rows]) and torch.equal(got[1], want[1][rows])


@pytest.mark.parametrize("algorithm", ["dds", "sp"])
def test_state_spec_cuts_row_leaves_only(algorithm):
    cfg = simulator.SimulationConfig(**{**CFG, "algorithm": algorithm}, overlap="delayed")
    ctx = engine.build_context(cfg, dataset=synthetic_mnist(**DATA))
    shard = vehicle_axis.VehicleSharding(group=object(), rank=1, num_shards=4)
    algo_state, stale = vehicle_axis.shard_state(ctx.state_spec(), ctx.init_state, shard)
    want_state, want_stale = ctx.init_state
    params = algo_state.params if algorithm == "dds" else algo_state.x
    full = want_state.params if algorithm == "dds" else want_state.x
    assert all(torch.equal(params[n], full[n][2:4]) for n in full)
    assert all(torch.equal(stale[n], want_stale[n][2:4]) for n in want_stale)
    assert algo_state.state_matrix is want_state.state_matrix      # replicated
    if algorithm == "sp":
        assert algo_state.y is want_state.y
    else:
        assert torch.equal(algo_state.opt_state.count, want_state.opt_state.count[2:4])
    assert vehicle_axis.shard_state(ctx.state_spec(), ctx.init_state,
                                    vehicle_axis.GLOBAL) is ctx.init_state


@pytest.mark.parametrize("algorithm", ["dds", "sp"])
def test_shard_map_without_a_group_is_the_vmap_run(algorithm):
    """No process group: the shard_map backend runs the global path, as the
    reference does on one device."""
    ds = synthetic_mnist(**DATA)
    kw = dict(algorithm=algorithm, comm_range=250.0)
    got, _ = _run(kw, ds, backend="shard_map")
    want, _ = _run(kw, ds, backend="vmap")
    _assert_same_run(got, want, atol=0.0)
    assert backends.get_backend("shard_map").shard_for(
        simulator.SimulationConfig(**CFG), K) is vehicle_axis.GLOBAL


def test_consensus_distance_global_path_unchanged():
    r = np.random.default_rng(4)
    params = {"a": T(r.normal(size=(K, 6)).astype(np.float32)),
              "b": T(r.normal(size=(K, 2, 3)).astype(np.float32))}
    flat = torch.cat([params["a"], params["b"].reshape(K, -1)], dim=1)
    want = torch.sum((flat - flat.mean(0)) ** 2) / K
    for shard in (None, vehicle_axis.GLOBAL):
        got = aggregation.consensus_distance(params, shard=shard)
        assert torch.allclose(got, want, atol=1e-6, rtol=0)
        assert torch.equal(got, aggregation.consensus_distance(params))


# ------------------------------------------------- transport and mesh ----

@pytest.mark.parametrize("local_rank,local_world,cards,ok", [
    (0, 1, 1, True), (1, 2, 2, True), (3, 4, 4, True),
    (0, 2, 1, False), (1, 2, 1, False), (0, 4, 2, False), (2, 2, 2, False)])
def test_nccl_on_a_shared_card_raises(local_rank, local_world, cards, ok):
    if ok:
        mesh_lib.check_nccl_cards(local_rank, local_world, cards)
    else:
        with pytest.raises(ValueError, match="one card per rank"):
            mesh_lib.check_nccl_cards(local_rank, local_world, cards)


@pytest.mark.parametrize("transport,device,ok", [
    ("gloo", "cpu", True), ("gloo", "cuda", False), ("nccl", "cpu", False),
    ("nccl", "cuda", True), ("gloo_staged", "cuda:0", True), ("gloo_staged", "cpu", False),
    ("mpi", "cpu", False)])
def test_the_transport_is_checked_against_the_device(transport, device, ok):
    if ok:
        mesh_lib.check_transport(transport, device)
    else:
        with pytest.raises(ValueError):
            mesh_lib.check_transport(transport, device)


def test_single_process_fallbacks():
    assert mesh_lib.initialize_multihost(num_processes=1) == 1
    assert mesh_lib.initialize_multihost() == 1          # no torchrun environment
    assert mesh_lib.world_size() == 1 and mesh_lib.is_rank_zero()
    assert mesh_lib.transport() is None
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        mesh_lib.make_multihost_federation_mesh()
    with pytest.raises(ValueError, match="256 ranks"):
        mesh_lib.make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        mesh_lib.make_federation_mesh(multi_pod=True, vehicle=4, fsdp=4)
    with pytest.raises(ValueError, match="must be 16"):
        mesh_lib.make_federation_mesh(vehicle=4, fsdp=2)
    with pytest.raises(ValueError):
        mesh_lib.initialize_multihost(num_processes=2, transport="mpi")


@pytest.mark.parametrize("n", [2, 4])
def test_the_mesh_of_the_ranks(spawned, n):
    ranks, _ = spawned
    for rank, out in enumerate(ranks[n]):
        assert out["mesh"] == dict(
            names=("vehicle", "fsdp", "model"), shape=(n, 1, 1), vehicle_axes=("vehicle",),
            data_axes=("data",), total=n, vehicles=3, group_size=n, transport="gloo")
        assert out["shard"] == (rank, n, False)


# -------------------------------------------------------- sharded_mix ----

@pytest.mark.parametrize("mix_fn", list(MIX_FNS))
@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_mix_matches_reference(spawned, n, fmt, bucketed, mix_fn):
    from repro.core import aggregation as ref_aggregation
    from repro.core import contacts as ref_contacts
    import jax.numpy as jnp
    ranks, _ = spawned
    dense, idx, w, params = _mix_inputs()
    mixing = (jnp.asarray(dense) if fmt == "dense"
              else ref_contacts.SparseMixing(jnp.asarray(idx), jnp.asarray(w)))
    want = ref_aggregation.mix_params(mixing, {n: jnp.asarray(x) for n, x in params.items()})
    for out in ranks[n]:
        got = out["mix"][(fmt, mix_fn, bucketed)]
        for name in params:
            np.testing.assert_allclose(got[name], np.asarray(want[name]), atol=1e-5, rtol=0,
                                       err_msg=name)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n", [2, 4])
def test_bucketed_mix_is_the_per_leaf_mix_bit_for_bit(spawned, n, fmt):
    ranks, _ = spawned
    for out in ranks[n]:
        assert out["buckets"] >= 2
        for mix_fn in MIX_FNS:
            per_leaf = out["mix"][(fmt, mix_fn, False)]
            bucketed = out["mix"][(fmt, mix_fn, True)]
            for name in per_leaf:
                np.testing.assert_array_equal(bucketed[name], per_leaf[name], err_msg=name)


# ----------------------------------------------------------- end to end ----

@pytest.mark.parametrize("case", list(RUNS_2))
def test_sharded_run_matches_vmap_on_2_ranks(spawned, case):
    ranks, vmap = spawned
    got, want = ranks[2][0]["runs"][case], vmap[case]
    _assert_same_run(got, want)
    if case.endswith("anchor"):    # W = I: delayed equals sync bit for bit
        for f in STATE_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)), err_msg=f)
    assert got.vehicle_accuracy[0].shape == (K,)
    assert sum(got.comm_mb) > 0 or case.endswith("anchor")


@pytest.mark.parametrize("case", list(RUNS_4))
def test_sharded_run_matches_vmap_on_4_ranks(spawned, case):
    ranks, vmap = spawned
    _assert_same_run(ranks[4][0]["runs"][case], vmap[f"n4:{case}"])


@pytest.mark.parametrize("n", [2, 4])
def test_every_rank_returns_the_same_result(spawned, n):
    ranks, _ = spawned
    first = ranks[n][0]["runs"]
    for out in ranks[n][1:]:
        for case, result in out["runs"].items():
            for f in FIELDS:
                np.testing.assert_array_equal(np.asarray(getattr(result, f), float),
                                              np.asarray(getattr(first[case], f), float),
                                              err_msg=f"{case} {f}")


def test_bucketed_run_is_the_per_leaf_run_bit_for_bit(spawned):
    ranks, _ = spawned
    runs = ranks[2][0]["runs"]
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(runs["dds/sparse/buckets"], f), float),
                                      np.asarray(getattr(runs["dds/sparse/per_leaf"], f), float),
                                      err_msg=f)


def test_run_seeds_sharded_matches_vmap(spawned):
    ranks, vmap = spawned
    got = ranks[2][0]["seeds"]
    assert len(got) == len(SEEDS) == len(vmap["seeds"])
    for res, want in zip(got, vmap["seeds"]):
        _assert_same_run(res, want)
    assert got[0].kl_trace != got[1].kl_trace


def test_final_state_is_reassembled_on_every_rank(spawned):
    ranks, vmap = spawned
    want = vmap["final_state"]
    for out in ranks[2]:
        states, params = out["final_state"]
        np.testing.assert_array_equal(states, want.state_matrix.numpy())
        for name, x in want.params.items():
            assert params[name].shape == tuple(x.shape)
            np.testing.assert_allclose(params[name], x.numpy(), atol=1e-5, rtol=0)


def test_reduce_scatter_is_a_phase_span(spawned):
    ranks, _ = spawned
    assert {"reduce_scatter", "mix", "p1_solve", "local_train", "eval"} <= set(
        ranks[2][0]["phases"])


@pytest.mark.parametrize("n,launch", [(2, 1), (4, 3)])
def test_a_fleet_that_does_not_divide_over_the_ranks_raises(spawned, n, launch):
    ranks, _ = spawned
    for out in ranks[n]:
        assert out["indivisible"] is not None
        assert f"launch {launch} rank" in out["indivisible"]


@pytest.mark.parametrize("contact_format", FORMATS)
def test_sharded_state_trajectory_matches_reference(spawned, contact_format):
    """The state side of the sharded run against the JAX package's
    run_simulation on the same configuration (as test_torch_slice does for
    the vmap backend)."""
    from repro.data.synthetic import synthetic_mnist as ref_synthetic_mnist
    from repro.fed import simulator as ref_sim
    ranks, _ = spawned
    base = {k: v for k, v in CFG.items() if k != "device"}
    base.update(comm_range=250.0, contact_format=contact_format)
    want = ref_sim.run_simulation(ref_sim.SimulationConfig(**base),
                                  dataset=ref_synthetic_mnist(**DATA))
    got = ranks[2][0]["runs"][f"dds/{contact_format}/near"]
    assert got.epochs_evaluated == want.epochs_evaluated
    for f in STATE_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(got, f), float),
                                   np.asarray(getattr(want, f), float), atol=1e-5, rtol=0,
                                   err_msg=f)


def test_every_algorithm_declares_its_state_layout():
    ctx_cfg = simulator.SimulationConfig(**CFG)
    for name in algorithms.available_algorithms():
        cfg = replace(ctx_cfg, algorithm=name)
        ctx = engine.build_context(cfg, dataset=synthetic_mnist(**DATA))
        spec = ctx.state_spec()
        leaves = [x for x in spec if x in (vehicle_axis.ROW, vehicle_axis.REPLICATED)]
        assert len(leaves) == len(spec) and vehicle_axis.ROW in leaves
