"""Port vs reference, the baselines slice: the three baseline mixing matrices,
one injected round of each baseline (JAX-initialised weights through
``convert``, identical batches, dropout off; every output), ``run_simulation``
of each baseline end to end, and ``fed/metrics``.

Tolerance atol 1e-5, as for the DDS slice: what depends only on the
numpy-seeded mobility trace and the partition — contacts, mixing, the state
matrix, ``kl_trace``, ``entropy``, ``kl_divergence``, ``comm_mb`` — follows
the reference's trajectory; what depends on SGD noise is compared by
injection.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as ref_agg
from repro.core import baselines as ref_base
from repro.core import contacts as ref_contacts
from repro.core import dfl_dds as ref_dds
from repro.data.synthetic import synthetic_mnist as ref_synthetic_mnist
from repro.fed import engine as ref_engine
from repro.fed import metrics as ref_metrics
from repro.fed import simulator as ref_sim
from repro.fed import topology as ref_topo
from repro.models import cnn as ref_cnn
from repro.optim import sgd as ref_sgd
from repro_torch import convert
from repro_torch.core import aggregation, baselines, contacts
from repro_torch.data import pipeline
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.fed import engine, metrics, simulator
from repro_torch.fed.algorithms import available_algorithms, sp as sp_algo
from repro_torch.kernels.gossip_mix import mix_params_cuda
from repro_torch.models import cnn
from repro_torch.optim import sgd

T = torch.as_tensor


def _graph(k, seed, density=0.4):
    """Symmetric 0/1 contacts with self-loops, and its neighbour lists (one
    padding slot)."""
    r = np.random.default_rng(seed)
    c = np.triu(r.random((k, k)) < density, 1)
    c = (c | c.T | np.eye(k, dtype=bool)).astype(np.float32)
    idx, mask = ref_topo.neighbour_lists(c, ref_topo.max_contact_degree(c) + 1)
    return c, idx, mask


def _both(c, idx, mask, sparse):
    if sparse:
        return (ref_contacts.SparseContacts(jnp.asarray(idx), jnp.asarray(mask)),
                contacts.SparseContacts(T(idx), T(mask)))
    return jnp.asarray(c), T(c)


def _assert_mixing(got, want, atol=1e-6):
    if isinstance(want, ref_contacts.SparseMixing):
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        got, want = got.w, want.w
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


# ------------------------------------------------------------- mixing ----

@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("kind", ["metropolis", "sample_size", "push_sum"])
@pytest.mark.parametrize("k,seed", [(6, 0), (19, 3)])
def test_baseline_mixing_matches_reference(kind, sparse, k, seed):
    c, idx, mask = _graph(k, seed)
    cj, ct = _both(c, idx, mask, sparse)
    counts = np.random.default_rng(seed).integers(0, 50, size=k).astype(np.float32)
    if kind == "metropolis":
        want, got = ref_agg.metropolis_mixing(cj), aggregation.metropolis_mixing(ct)
    elif kind == "sample_size":
        want = ref_agg.sample_size_mixing(cj, jnp.asarray(counts))
        got = aggregation.sample_size_mixing(ct, T(counts))
    else:
        want, got = ref_base.push_sum_mixing(cj), baselines.push_sum_mixing(ct)
    _assert_mixing(got, want)
    dense = contacts.mixing_to_dense(got) if sparse else got.numpy()
    axis = 0 if kind == "push_sum" else 1       # push-sum is column-stochastic
    rows = dense.sum(axis)
    np.testing.assert_allclose(rows[rows > 0], 1.0, atol=1e-5)


# ------------------------------------------------- one injected round ----

K, E, B, LR = 5, 2, 6, 0.1


def _round_inputs(with_rsu):
    r = np.random.default_rng(11)
    init = ref_cnn.mnist_cnn_init(jax.random.PRNGKey(0))
    params = {n: np.stack([np.asarray(v)] * K)
              + (0.05 * r.normal(size=(K,) + v.shape)).astype(np.float32)
              for n, v in init.items()}
    state = r.dirichlet(np.ones(K), size=K).astype(np.float32)
    counts = np.array([5, 9, 3, 7, 0 if with_rsu else 4], np.float32)
    xs = r.random((K, E, B, 28, 28, 1)).astype(np.float32)
    ys = r.integers(0, 10, size=(K, E, B)).astype(np.int32)
    y_push = r.uniform(0.5, 1.5, size=K).astype(np.float32)
    return params, state, counts, xs, ys, y_push


def _ref_loss(p, x, y, rng):
    return ref_cnn.nll_loss(ref_cnn.mnist_cnn_apply(p, x, rng=None, train=False), y)


def _loss(p, x, y, generator=None):
    return cnn.nll_loss(cnn.mnist_cnn_apply(p, x, train=False), y)


@pytest.mark.parametrize("case", ["dense", "sparse+rsu"])
@pytest.mark.parametrize("algo", ["dfl", "d_sgd", "d_fedavg", "sp"])
def test_injected_round_matches_reference(algo, case):
    with_rsu = case.endswith("rsu")
    params, state, counts, xs, ys, y_push = _round_inputs(with_rsu)
    c, idx, mask = _graph(K, 4, density=0.5)
    cj, ct = _both(c, idx, mask, case.startswith("sparse"))
    target = counts / counts.sum()
    local_mask = (counts > 0).astype(np.float32) if with_rsu else None
    lm_j = None if local_mask is None else jnp.asarray(local_mask)
    lm_t = None if local_mask is None else T(local_mask)
    jparams = {n: jnp.asarray(v) for n, v in params.items()}

    if algo == "sp":
        def ref_grad(p, b, key):
            loss, grads = jax.value_and_grad(_ref_loss)(p, b[0], b[1], key)
            return grads, {"loss": loss}

        full = (xs[:, 0], ys[:, 0])
        ps_j = ref_base.PushSumState(jparams, jnp.asarray(y_push), jnp.asarray(state),
                                     jnp.asarray(7, jnp.int32))
        want, want_d = ref_base.sp_round(ps_j, cj, jnp.asarray(target),
                                         tuple(map(jnp.asarray, full)),
                                         jax.random.PRNGKey(1), ref_grad, lr=LR)
        ps_t = baselines.PushSumState(convert.params_from_numpy(params), T(y_push),
                                      T(state), T(np.int32(7)))
        got, got_d = baselines.sp_round(ps_t, ct, T(target), (T(full[0]), T(full[1]).long()),
                                        None, sp_algo.make_grad_fn(_loss), lr=LR,
                                        mix_params_fn=mix_params_cuda)
        np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), atol=1e-6)
        got_params, want_params = got.x, want.x
        for n, v in baselines.sp_model(got).items():
            np.testing.assert_allclose(v.numpy(), np.asarray(ref_base.sp_model(want)[n]),
                                       atol=1e-5)
        names = ("kl_divergence", "entropy", "loss", "push_weights")
    else:
        opt = ref_sgd(LR)
        count0 = np.full((K,), 4, np.int32)
        fed_j = ref_dds.FederationState(
            jparams, jax.vmap(opt.init)(jparams)._replace(count=jnp.asarray(count0)),
            jnp.asarray(state), jnp.asarray(7, jnp.int32))
        kw = dict(lr=LR, local_steps=E)
        if algo != "d_sgd":
            kw["sample_counts"] = counts
        want, want_d = getattr(ref_base, f"{algo}_round")(
            fed_j, cj, jnp.asarray(target), (jnp.asarray(xs), jnp.asarray(ys)),
            jax.random.PRNGKey(1), ref_engine.make_local_train_fn(_ref_loss, opt),
            local_mask=lm_j, **{n: jnp.asarray(v) if n == "sample_counts" else v
                                for n, v in kw.items()})
        fed_t = convert.federation_state_from_numpy(params, count0, state, 7)
        got, got_d = getattr(baselines, f"{algo}_round")(
            fed_t, ct, T(target), (T(xs), T(ys).long()), None,
            engine.make_local_train_fn(_loss, sgd(LR)), local_mask=lm_t,
            mix_params_fn=mix_params_cuda,
            **{n: T(v) if n == "sample_counts" else v for n, v in kw.items()})
        np.testing.assert_array_equal(got.opt_state.count.numpy(),
                                      np.asarray(want.opt_state.count))
        _assert_mixing(got_d["mixing"], want_d["mixing"])
        got_params, want_params = got.params, want.params
        names = ("kl_divergence", "entropy", "loss")

    for n in params:
        np.testing.assert_allclose(got_params[n].numpy(), np.asarray(want_params[n]),
                                   atol=1e-5)
    np.testing.assert_allclose(got.state_matrix.numpy(), np.asarray(want.state_matrix),
                               atol=1e-5)
    assert int(got.epoch) == int(want.epoch) == 8
    for name in names:
        np.testing.assert_allclose(got_d[name].numpy(), np.asarray(want_d[name]), atol=1e-5)


def test_sample_full_batches_gathers_from_each_partition():
    r = np.random.default_rng(0)
    x = r.random((30, 2)).astype(np.float32)
    y = np.arange(30)
    table = r.integers(0, 30, size=(4, 7))
    data = pipeline.make_federated_data(x, y, table, np.full(4, 7))
    picks = T(r.integers(0, 7, size=(4, 5)))
    bx, by = pipeline.sample_full_batches(data, None, 5, picks=picks)
    assert bx.shape == (4, 5, 2) and by.shape == (4, 5)
    np.testing.assert_array_equal(by.numpy(), np.take_along_axis(table, picks.numpy(), 1))
    drawn_x, drawn_y = pipeline.sample_full_batches(data, torch.Generator().manual_seed(0), 9)
    assert drawn_x.shape == (4, 9, 2)
    assert all(set(drawn_y[k].tolist()) <= set(table[k].tolist()) for k in range(4))


# ------------------------------------------------------- the whole run ----

@pytest.fixture(scope="module")
def datasets():
    return (ref_synthetic_mnist(n_train=1200, n_test=200),
            synthetic_mnist(n_train=1200, n_test=200))


@pytest.mark.parametrize("case", ["plain", "rsu+drops"])
@pytest.mark.parametrize("contact_format", ["sparse", "dense"])
@pytest.mark.parametrize("algo", ["dfl", "d_sgd", "d_fedavg", "sp"])
def test_run_simulation_follows_reference_trajectory(datasets, algo, contact_format, case):
    ds_ref, ds = datasets
    extra = dict(num_rsus=1, p_drop=0.2) if case == "rsu+drops" else {}
    base = dict(algorithm=algo, num_vehicles=6, epochs=4, eval_every=2,
                eval_samples=100, local_steps=2, batch_size=16, lr=0.15, seed=0,
                comm_range=250.0, contact_format=contact_format, **extra)
    want = ref_sim.run_simulation(ref_sim.SimulationConfig(**base), dataset=ds_ref)
    got = simulator.run_simulation(simulator.SimulationConfig(**base, device="cpu"),
                                   dataset=ds)
    assert got.epochs_evaluated == want.epochs_evaluated == [2, 4]
    np.testing.assert_allclose(got.kl_trace, want.kl_trace, atol=1e-5)
    np.testing.assert_allclose(got.comm_mb, want.comm_mb, atol=1e-5)
    np.testing.assert_allclose(np.stack(got.entropy), np.stack(want.entropy), atol=1e-5)
    np.testing.assert_allclose(np.stack(got.kl_divergence), np.stack(want.kl_divergence),
                               atol=1e-5)
    assert sum(want.comm_mb) > 0
    assert np.isfinite(got.avg_accuracy).all() and np.isfinite(got.consensus_distance).all()


def test_every_reference_algorithm_is_registered():
    from repro.fed.algorithms import available_algorithms as ref_available
    assert available_algorithms() == ref_available()


# ------------------------------------------------------------ metrics ----

def test_metrics_are_bit_equal_to_reference():
    r = np.random.default_rng(3)
    acc = r.random(40)
    curve = np.sort(r.random(30))
    grid = np.linspace(0, 1, 11)
    per_seed = r.random((5, 7))
    for got, want in [
        (metrics.accuracy_cdf(acc), ref_metrics.accuracy_cdf(acc)),
        (metrics.accuracy_cdf(acc, grid), ref_metrics.accuracy_cdf(acc, grid)),
        (metrics.mean_std(per_seed), ref_metrics.mean_std(per_seed)),
        (metrics.mean_std(per_seed, axis=1), ref_metrics.mean_std(per_seed, axis=1)),
    ]:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    x, y = r.random(25), r.random(25)
    assert metrics.pearson(x, y) == ref_metrics.pearson(x, y)
    assert metrics.pearson(np.ones(5), x[:5]) == ref_metrics.pearson(np.ones(5), x[:5]) == 0.0
    for target in (0.3, 0.9, 2.0):
        assert metrics.epochs_to_target(curve, target) == ref_metrics.epochs_to_target(curve, target)
    assert metrics.epochs_to_target(curve, 2.0) is None
    for trace in (curve[::-1], np.array([])):
        assert metrics.diversity_gain(trace) == ref_metrics.diversity_gain(trace)
