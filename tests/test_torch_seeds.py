"""The seed axis in the port: the stacking helpers against the reference
(bit for bit), ``run_seeds`` against single runs (every field, 1e-5) and
against the reference's ``run_seeds`` (the deterministic traces, 1e-5), the
per-epoch loop against the engine, the core functions and the two mixes with
a leading seed axis.
"""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import contacts as ref_contacts
from repro.data import pipeline as ref_pipeline
from repro.data.synthetic import synthetic_mnist as ref_synthetic_mnist
from repro.fed import engine as ref_engine
from repro.fed import topology as ref_topo
from repro.kernels.gossip_mix import ref as ref_mix
from repro_torch.core import aggregation, baselines, contacts, kl_solver, state_vector
from repro_torch.data import pipeline
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.fed import engine, simulator
from repro_torch.kernels.gossip_mix import kernel, mix_params_cuda, ref

T = torch.as_tensor
FIELDS = ("avg_accuracy", "vehicle_accuracy", "entropy", "kl_divergence",
          "consensus_distance", "kl_trace", "comm_mb")


@pytest.fixture(scope="module")
def tiny_ds():
    return synthetic_mnist(n_train=1200, n_test=200)


def _cfg(**kw):
    base = dict(algorithm="dds", num_vehicles=6, epochs=4, eval_every=2,
                eval_samples=200, local_steps=2, batch_size=16, p1_steps=20,
                lr=0.15, comm_range=250.0, device="cpu")
    base.update(kw)
    return simulator.SimulationConfig(**base)


def _assert_same_run(got, want, atol=1e-5):
    assert got.epochs_evaluated == want.epochs_evaluated
    for f in FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(got, f), float),
                                   np.asarray(getattr(want, f), float),
                                   atol=atol, rtol=0, err_msg=f)


# ------------------------------------------------------------ stacking helpers

def _neighbour_window(t, k, d_extra, seed):
    r = np.random.default_rng(seed)
    idx, mask = [], []
    for _ in range(t):
        c = np.triu(r.random((k, k)) < 0.4, 1)
        c = (c | c.T | np.eye(k, dtype=bool)).astype(np.float32)
        i, m = ref_topo.neighbour_lists(c, int(c.sum(1).max()) + d_extra)
        idx.append(i)
        mask.append(m)
    d = max(i.shape[1] for i in idx)
    padded = [ref_contacts.pad_slots(ref_contacts.SparseContacts(i, m), d)
              for i, m in zip(idx, mask)]
    return ref_contacts.SparseContacts(np.stack([p.idx for p in padded]),
                                       np.stack([p.mask for p in padded]))


def test_stack_windows_matches_reference_bitwise():
    sparse = [_neighbour_window(3, 6, extra, s) for s, extra in ((0, 0), (1, 3), (2, 1))]
    want = ref_contacts.stack_windows(sparse)
    got = contacts.stack_windows([contacts.SparseContacts(w.idx, w.mask) for w in sparse])
    for a, b in ((got.idx, want.idx), (got.mask, want.mask)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    dense = [np.random.default_rng(s).random((3, 5, 5)).astype(np.float32) for s in range(3)]
    np.testing.assert_array_equal(contacts.stack_windows([T(d) for d in dense]),
                                  ref_contacts.stack_windows(dense))


@pytest.mark.parametrize("widths", [(9, 9, 9), (5, 9, 7)])
def test_stack_federated_data_matches_reference_bitwise(widths):
    """Equal tables stack as they are; narrower ones are padded by the
    reference's resampling draw, bit for bit."""
    ds = synthetic_mnist(n_train=300, n_test=10)
    r = np.random.default_rng(3)
    tables = [r.integers(0, 300, size=(4, w)) for w in widths]
    counts = [r.integers(1, w + 1, size=4) for w in widths]
    ours = [pipeline.make_federated_data(ds.train_x, ds.train_y, t, c)
            for t, c in zip(tables, counts)]
    theirs = [ref_pipeline.make_federated_data(ds.train_x, ds.train_y, t, c)
              for t, c in zip(tables, counts)]
    want = ref_pipeline.stack_federated_data(theirs, seed=7)
    got = pipeline.stack_federated_data(ours, seed=7)
    assert got.index_table.shape == (3, 4, max(widths))
    np.testing.assert_array_equal(got.index_table.numpy(), np.asarray(want.index_table))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert got.x is ours[0].x                      # train tensors shared, not stacked
    view = pipeline.seed_view(got, 2)
    np.testing.assert_array_equal(view.index_table[:, :widths[2]].numpy(), tables[2])
    np.testing.assert_array_equal(view.counts.numpy(), counts[2])


def test_stack_federated_data_refuses_per_seed_datasets():
    a = pipeline.make_federated_data(np.zeros((4, 2)), np.arange(4), np.zeros((2, 2)),
                                     np.ones(2))
    b = pipeline.make_federated_data(np.zeros((4, 2)), np.arange(4)[::-1].copy(),
                                     np.zeros((2, 2)), np.ones(2))
    with pytest.raises(ValueError, match="shared"):
        pipeline.stack_federated_data([a, b])


# ------------------------------------------------------------ run_seeds itself

@pytest.mark.parametrize("contact_format", ["sparse", "dense"])
@pytest.mark.parametrize("algorithm", ["dds", "dfl"])
def test_run_seeds_matches_single_runs(tiny_ds, algorithm, contact_format):
    """Every trajectory field of every seed, accuracy included, to 1e-5."""
    cfg = _cfg(algorithm=algorithm, contact_format=contact_format)
    batch = engine.run_seeds(cfg, [0, 1, 2], dataset=tiny_ds)
    assert [r.config.seed for r in batch] == [0, 1, 2]
    for seed, res in enumerate(batch):
        solo = simulator.run_simulation(replace(cfg, seed=seed), dataset=tiny_ds)
        _assert_same_run(res, solo)
        assert res.wall_time == 0.0          # one loop for all seeds, as the reference


@pytest.mark.parametrize("algorithm", ["sp", "d_sgd", "d_fedavg"])
def test_run_seeds_matches_single_runs_other_baselines(tiny_ds, algorithm):
    cfg = _cfg(algorithm=algorithm, epochs=3, eval_every=3, num_rsus=1, p_drop=0.2)
    batch = engine.run_seeds(cfg, [0, 1], dataset=tiny_ds)
    for seed, res in enumerate(batch):
        _assert_same_run(res, simulator.run_simulation(replace(cfg, seed=seed),
                                                       dataset=tiny_ds))


def test_run_seeds_delayed_and_chunked_windows_match_single_runs(tiny_ds):
    cfg = _cfg(overlap="delayed", window_size=3, epochs=5)
    batch = engine.run_seeds(cfg, [1, 2], dataset=tiny_ds)
    for seed, res in zip((1, 2), batch):
        _assert_same_run(res, simulator.run_simulation(replace(cfg, seed=seed),
                                                       dataset=tiny_ds))


def test_run_seeds_unbalanced_widths(tiny_ds):
    cfg = _cfg(distribution="unbalanced_iid", epochs=3, eval_every=3)
    results = engine.run_seeds(cfg, seeds=(0, 1, 2), dataset=tiny_ds)
    assert len(results) == 3
    for res in results:
        assert res.epochs_evaluated == [3] and np.isfinite(res.final_accuracy())


@pytest.mark.parametrize("overlap", ["sync", "delayed"])
@pytest.mark.parametrize("contact_format", ["sparse", "dense"])
def test_run_seeds_follows_reference_run_seeds(tiny_ds, contact_format, overlap):
    """Per seed, the traces that depend only on the numpy-seeded mobility and
    partition follow the reference's vmapped ``run_seeds``."""
    base = dict(num_vehicles=6, epochs=3, eval_every=3, eval_samples=100,
                local_steps=1, batch_size=8, p1_steps=20, lr=0.15, comm_range=250.0,
                contact_format=contact_format, overlap=overlap)
    want = ref_engine.run_seeds(ref_engine.SimulationConfig(**base), [0, 1, 2],
                                dataset=ref_synthetic_mnist(n_train=1200, n_test=200))
    got = engine.run_seeds(simulator.SimulationConfig(**base, device="cpu"), [0, 1, 2],
                           dataset=tiny_ds)
    for g, w in zip(got, want):
        assert g.epochs_evaluated == w.epochs_evaluated
        np.testing.assert_allclose(np.stack(g.kl_divergence), np.stack(w.kl_divergence),
                                   atol=1e-5)
        np.testing.assert_allclose(np.stack(g.entropy), np.stack(w.entropy), atol=1e-5)
        np.testing.assert_allclose(g.comm_mb, w.comm_mb, atol=1e-5)
        np.testing.assert_allclose(g.kl_trace, w.kl_trace, atol=1e-5)


# ------------------------------------------------------- the per-epoch loop

@pytest.mark.parametrize("algorithm", ["dds", "dfl", "sp"])
def test_legacy_loop_matches_engine(tiny_ds, algorithm):
    cfg = _cfg(algorithm=algorithm)
    legacy = simulator.run_simulation(replace(cfg, use_scan_engine=False), dataset=tiny_ds)
    window = simulator.run_simulation(cfg, dataset=tiny_ds)
    _assert_same_run(legacy, window)
    assert legacy.wall_time > 0


def test_legacy_loop_with_rsus_and_drops(tiny_ds):
    cfg = _cfg(num_rsus=2, p_drop=0.25, epochs=5, eval_every=2, contact_format="dense")
    legacy = simulator.run_simulation(replace(cfg, use_scan_engine=False), dataset=tiny_ds)
    _assert_same_run(legacy, simulator.run_simulation(cfg, dataset=tiny_ds))
    assert all(len(a) == cfg.num_vehicles for a in legacy.vehicle_accuracy)
    assert all(len(e) == cfg.num_vehicles + cfg.num_rsus for e in legacy.entropy)


# ------------------------------------------- core functions with a seed axis

def _graphs(k, seeds=3, d_extra=1):
    windows = [_neighbour_window(1, k, d_extra + s, s) for s in range(seeds)]
    stacked = ref_contacts.stack_windows(windows)
    sparse = contacts.SparseContacts(T(stacked.idx[:, 0]), T(stacked.mask[:, 0]))
    dense = torch.stack([T(ref_topo.dense_from_neighbours(w.idx[0], w.mask[0]))
                         for w in windows])
    return sparse, dense


@pytest.mark.parametrize("sparse", [False, True])
def test_p1_and_state_vectors_take_a_seed_axis(sparse):
    k, seeds = 7, 3
    sp, de = _graphs(k, seeds)
    c = sp if sparse else de
    r = np.random.default_rng(0)
    states = T(r.dirichlet(np.ones(k), size=(seeds, k)).astype(np.float32))
    target = T(r.dirichlet(np.ones(k), size=seeds).astype(np.float32))
    mask = T((r.random((seeds, k)) > 0.2).astype(np.float32))
    alpha = kl_solver.solve_p1_all(states, target, c, num_steps=30, step_size=2.0)
    mixing = aggregation.mixing_from_alpha(alpha, c)
    agg = state_vector.local_update(state_vector.aggregate(states, mixing), 0.1, 2,
                                    update_mask=mask)
    kl = state_vector.kl_to_target(agg, target)
    for s in range(seeds):
        c1 = contacts.SparseContacts(sp.idx[s], sp.mask[s]) if sparse else de[s]
        a1 = kl_solver.solve_p1_all(states[s], target[s], c1, num_steps=30, step_size=2.0)
        m1 = aggregation.mixing_from_alpha(a1, c1)
        g1 = state_vector.local_update(state_vector.aggregate(states[s], m1), 0.1, 2,
                                       update_mask=mask[s])
        np.testing.assert_allclose(alpha[s].numpy(), a1.numpy(), atol=1e-6)
        np.testing.assert_allclose(agg[s].numpy(), g1.numpy(), atol=1e-6)
        np.testing.assert_allclose(kl[s].numpy(),
                                   state_vector.kl_to_target(g1, target[s]).numpy(), atol=1e-6)
        assert float(contacts.count_edges(c1)) == float(contacts.count_edges(c)[s])


@pytest.mark.parametrize("sparse", [False, True])
def test_baseline_mixings_take_a_seed_axis(sparse):
    k, seeds = 6, 3
    sp, de = _graphs(k, seeds)
    c = sp if sparse else de
    counts = T(np.random.default_rng(1).integers(1, 9, size=(seeds, k)).astype(np.float32))
    y = T(np.random.default_rng(2).random((seeds, k)).astype(np.float32) + 0.5)
    for make in (aggregation.uniform_mixing, aggregation.metropolis_mixing,
                 baselines.push_sum_mixing,
                 lambda cc: aggregation.sample_size_mixing(
                     cc, counts if cc is c else counts[make.s])):
        make.s = 0
        m = make(c)
        for s in range(seeds):
            make.s = s
            c1 = contacts.SparseContacts(sp.idx[s], sp.mask[s]) if sparse else de[s]
            m1 = make(c1)
            got = contacts.SparseMixing(m.idx[s], m.w[s]) if sparse else m[s]
            if sparse:
                np.testing.assert_allclose(contacts.mixing_to_dense(got),
                                           contacts.mixing_to_dense(m1), atol=1e-6)
            else:
                np.testing.assert_allclose(got.numpy(), m1.numpy(), atol=1e-6)
            np.testing.assert_allclose(contacts.mix_vector(m, y)[s].numpy(),
                                       contacts.mix_vector(m1, y[s]).numpy(), atol=1e-6)


# ------------------------------------------------- the mixes with a seed axis

def _seed_mix_case(seeds, k, p, d, seed, neighbour_only):
    r = np.random.default_rng(seed)
    w = r.dirichlet(np.ones(k), size=(seeds, k)).astype(np.float32)
    idx = r.integers(0, k, size=(seeds, k, d)).astype(np.int32)
    ws = r.random((seeds, k, d)).astype(np.float32)
    ws[..., -1] = 0.0
    if neighbour_only:          # delayed gossip: zero diagonal, one empty row
        w[:, np.arange(k), np.arange(k)] = 0.0
        w[0, 1] = 0.0
        ws[idx == np.arange(k)[None, :, None]] = 0.0
        ws[0, 1] = 0.0
    x = r.normal(size=(seeds, k, p)).astype(np.float32)
    return w, idx, ws, x


@pytest.mark.parametrize("neighbour_only", [False, True])
def test_seed_axis_plain_mixes_match_reference_seed_by_seed(neighbour_only):
    w, idx, ws, x = _seed_mix_case(3, 7, 13, 4, 0, neighbour_only)
    got_mm = ref.gossip_mix_matmul_ref(T(w), T(x))
    got_g = ref.gossip_mix_gather_ref(T(idx), T(ws), T(x))
    for s in range(3):
        np.testing.assert_allclose(
            got_mm[s].numpy(), np.asarray(ref_mix.gossip_mix_matmul_ref(jnp.asarray(w[s]),
                                                                 jnp.asarray(x[s]))),
            atol=1e-5)
        want = np.asarray(ref_mix.gossip_mix_gather_ref(
            jnp.asarray(idx[s]), jnp.asarray(ws[s]), jnp.asarray(x[s])))
        np.testing.assert_allclose(got_g[s].numpy(), want, atol=1e-5)
    if neighbour_only:          # the empty row mixes to exactly zero
        assert not got_mm[0, 1].any() and not got_g[0, 1].any()


@pytest.mark.parametrize("sparse", [False, True])
def test_mix_params_cuda_cpu_route_takes_a_seed_axis(sparse):
    """A CPU tensor goes to the seed-axis plain versions: the same as the
    plain torch mix seed by seed, and no kernel is launched."""
    w, idx, ws, _ = _seed_mix_case(3, 6, 1, 3, 4, False)
    r = np.random.default_rng(1)
    tree = {"a": T(r.normal(size=(3, 6, 2, 5)).astype(np.float32)),
            "b": T(r.normal(size=(3, 6, 7)).astype(np.float32))}
    mixing = contacts.SparseMixing(T(idx), T(ws)) if sparse else T(w)
    kernel.reset_launch_counts()
    got = mix_params_cuda(mixing, tree)
    plain = aggregation.mix_params(mixing, tree)
    assert sum(kernel.launch_counts.values()) == 0
    for s in range(3):
        one = (contacts.SparseMixing(T(idx[s]), T(ws[s])) if sparse else T(w[s]))
        want = aggregation.mix_params(one, {n: v[s] for n, v in tree.items()})
        for n in tree:
            assert got[n].shape == tree[n].shape
            np.testing.assert_allclose(got[n][s].numpy(), want[n].numpy(), atol=1e-5)
            np.testing.assert_allclose(plain[n][s].numpy(), want[n].numpy(), atol=1e-6)


def test_seed_axis_wrappers_refuse_cpu_tensors():
    w, idx, ws, x = _seed_mix_case(2, 4, 8, 3, 0, False)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.gossip_mix_matmul_grouped(T(w), [T(x)])
    with pytest.raises(ValueError, match="CUDA"):
        kernel.gossip_mix_gather_grouped(T(idx), T(ws), [T(x)])
