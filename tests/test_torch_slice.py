"""Port vs reference, the slice as a whole: one injected ``dds_round`` (every
output), and ``run_simulation`` end to end in both contact formats, with and
without RSUs / dropped exchanges.

What depends only on the numpy-seeded mobility trace and the partition —
contacts, P1 weights, mixing, the state matrix, ``kl_trace``, ``entropy``,
``kl_divergence``, ``comm_mb`` — must follow the reference's trajectory:
atol 1e-5 (the P1 solve's exp/log/softmax differ in the last bit between the
libraries, and <= 8 rounds do not amplify that past 1e-5). What depends on
SGD noise (the two stacks' random streams differ) is compared by injection
in the ``dds_round`` test, same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import contacts as ref_contacts
from repro.core import dfl_dds as ref_dds
from repro.data.synthetic import synthetic_mnist as ref_synthetic_mnist
from repro.fed import engine as ref_engine
from repro.fed import simulator as ref_sim
from repro.fed import topology as ref_topo
from repro.models import cnn as ref_cnn
from repro.optim import sgd as ref_sgd
from repro_torch import convert
from repro_torch.core import contacts, dfl_dds
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.fed import engine, simulator
from repro_torch.kernels.gossip_mix import mix_params_cuda
from repro_torch.models import cnn
from repro_torch.optim import sgd

T = torch.as_tensor


@pytest.fixture(scope="module")
def datasets():
    return (ref_synthetic_mnist(n_train=1200, n_test=200),
            synthetic_mnist(n_train=1200, n_test=200))


# ------------------------------------------------------ one injected round ----

@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("with_rsu", [False, True])
def test_dds_round_matches_reference(sparse, with_rsu):
    k, e, b, lr, steps = 5, 2, 6, 0.1, 30
    r = np.random.default_rng(11)
    init = ref_cnn.mnist_cnn_init(jax.random.PRNGKey(0))
    params = {n: np.stack([np.asarray(v)] * k)
              + (0.05 * r.normal(size=(k,) + v.shape)).astype(np.float32)
              for n, v in init.items()}
    c = np.triu(r.random((k, k)) < 0.5, 1)
    c = (c | c.T | np.eye(k, dtype=bool)).astype(np.float32)
    state = r.dirichlet(np.ones(k), size=k).astype(np.float32)
    counts = np.array([5, 9, 3, 7, 0 if with_rsu else 4], np.float32)
    target = counts / counts.sum()
    local_mask = (counts > 0).astype(np.float32) if with_rsu else None
    xs = r.random((k, e, b, 28, 28, 1)).astype(np.float32)
    ys = r.integers(0, 10, size=(k, e, b)).astype(np.int32)
    count0 = np.full((k,), 4, np.int32)
    if sparse:
        idx, mask = ref_topo.neighbour_lists(c, int(c.sum(1).max()) + 1)
        cj = ref_contacts.SparseContacts(jnp.asarray(idx), jnp.asarray(mask))
        ct = contacts.SparseContacts(T(idx), T(mask))
    else:
        cj, ct = jnp.asarray(c), T(c)

    def ref_loss(p, x, y, rng):
        return ref_cnn.nll_loss(ref_cnn.mnist_cnn_apply(p, x, rng=None, train=False), y)

    opt = ref_sgd(lr)
    fed_j = ref_dds.FederationState(
        {n: jnp.asarray(v) for n, v in params.items()},
        jax.vmap(opt.init)({n: jnp.asarray(v) for n, v in params.items()})._replace(
            count=jnp.asarray(count0)),
        jnp.asarray(state), jnp.asarray(7, jnp.int32))
    want, want_d = ref_dds.dds_round(
        fed_j, cj, jnp.asarray(target), (jnp.asarray(xs), jnp.asarray(ys)),
        jax.random.PRNGKey(1), ref_engine.make_local_train_fn(ref_loss, opt),
        lr=lr, local_steps=e, p1_steps=steps, p1_step_size=2.0,
        local_mask=None if local_mask is None else jnp.asarray(local_mask))

    def loss(p, x, y, generator=None):
        return cnn.nll_loss(cnn.mnist_cnn_apply(p, x, train=False), y)

    fed_t = convert.federation_state_from_numpy(params, count0, state, 7)
    got, got_d = dfl_dds.dds_round(
        fed_t, ct, T(target), (T(xs), T(ys).long()), None,
        engine.make_local_train_fn(loss, sgd(lr)),
        lr=lr, local_steps=e, p1_steps=steps, p1_step_size=2.0,
        mix_params_fn=mix_params_cuda,
        local_mask=None if local_mask is None else T(local_mask))

    for n in params:
        np.testing.assert_allclose(got.params[n].numpy(), np.asarray(want.params[n]), atol=1e-5)
    np.testing.assert_allclose(got.state_matrix.numpy(), np.asarray(want.state_matrix), atol=1e-5)
    np.testing.assert_array_equal(got.opt_state.count.numpy(), np.asarray(want.opt_state.count))
    assert int(got.epoch) == int(want.epoch) == 8
    for name in ("kl_divergence", "entropy", "loss"):
        np.testing.assert_allclose(got_d[name].numpy(), np.asarray(want_d[name]), atol=1e-5)
    mix_got, mix_want = got_d["mixing"], want_d["mixing"]
    if sparse:
        np.testing.assert_array_equal(mix_got.idx.numpy(), np.asarray(mix_want.idx))
        mix_got, mix_want = mix_got.w, mix_want.w
    np.testing.assert_allclose(mix_got.numpy(), np.asarray(mix_want), atol=1e-5)
    if with_rsu:   # the data-less row only mixes: no SGD step counted
        assert int(got.opt_state.count[-1]) == 4 and int(got.opt_state.count[0]) == 4 + e


def test_masked_update_keeps_old_rows():
    new = {"a": torch.ones(3, 2), "b": (torch.ones(3),)}
    old = {"a": torch.zeros(3, 2), "b": (torch.zeros(3),)}
    out = dfl_dds.masked_update(new, old, T([1.0, 0.0, 1.0]))
    assert out["a"].tolist() == [[1, 1], [0, 0], [1, 1]]
    assert out["b"][0].tolist() == [1, 0, 1]


# ---------------------------------------------------------- the whole run ----

CASES = {
    "plain": dict(),
    "rsus": dict(num_rsus=2),
    "drops": dict(p_drop=0.3),
    "rsus+drops": dict(num_rsus=1, p_drop=0.2, road_net="spider"),
}


@pytest.mark.parametrize("contact_format", ["sparse", "dense"])
@pytest.mark.parametrize("case", list(CASES))
def test_run_simulation_follows_reference_trajectory(datasets, contact_format, case):
    ds_ref, ds = datasets
    base = dict(algorithm="dds", num_vehicles=6, epochs=6, eval_every=3,
                eval_samples=200, local_steps=2, batch_size=16, p1_steps=30,
                lr=0.15, seed=0, comm_range=250.0, contact_format=contact_format,
                **CASES[case])
    want = ref_sim.run_simulation(ref_sim.SimulationConfig(**base), dataset=ds_ref)
    got = simulator.run_simulation(
        simulator.SimulationConfig(**base, device="cpu"), dataset=ds)
    assert got.epochs_evaluated == want.epochs_evaluated == [3, 6]
    np.testing.assert_allclose(got.kl_trace, want.kl_trace, atol=1e-5)
    np.testing.assert_allclose(got.comm_mb, want.comm_mb, atol=1e-5)
    np.testing.assert_allclose(np.stack(got.entropy), np.stack(want.entropy), atol=1e-5)
    np.testing.assert_allclose(np.stack(got.kl_divergence), np.stack(want.kl_divergence),
                               atol=1e-5)
    assert sum(want.comm_mb) > 0                      # vehicles did meet
    total = base["num_vehicles"] + base.get("num_rsus", 0)
    assert got.entropy[0].shape == (total,)
    assert got.vehicle_accuracy[0].shape == (base["num_vehicles"],)
    assert np.isfinite(got.consensus_distance).all() and np.isfinite(got.avg_accuracy).all()
    assert got.wall_time > 0 and len(got.kl_trace) == 6


def test_window_chunking_and_mixing_backend_do_not_change_the_trajectory(datasets):
    _, ds = datasets
    base = dict(num_vehicles=6, epochs=5, eval_every=2, eval_samples=100,
                local_steps=1, batch_size=8, p1_steps=20, comm_range=250.0,
                device="cpu")
    a = simulator.run_simulation(simulator.SimulationConfig(**base), dataset=ds)
    b = simulator.run_simulation(
        simulator.SimulationConfig(**base, window_size=2, mixing_backend="torch"),
        dataset=ds)
    assert a.epochs_evaluated == b.epochs_evaluated == [2, 4, 5]
    np.testing.assert_allclose(a.kl_trace, b.kl_trace, atol=1e-6)
    np.testing.assert_allclose(a.comm_mb, b.comm_mb, atol=0)
    np.testing.assert_allclose(a.avg_accuracy, b.avg_accuracy, atol=1e-6)
    np.testing.assert_allclose(a.consensus_distance, b.consensus_distance, rtol=1e-4)


def test_accuracy_climbs(datasets):
    _, ds = datasets
    cfg = simulator.SimulationConfig(
        num_vehicles=6, epochs=12, eval_every=4, eval_samples=200, local_steps=8,
        batch_size=32, p1_steps=20, lr=0.15, comm_range=250.0, device="cpu")
    res = simulator.run_simulation(cfg, dataset=ds)
    assert res.epochs_evaluated == [4, 8, 12]
    # chance is 0.10; the reference reaches ~0.36 on this configuration
    assert res.avg_accuracy[-1] > res.avg_accuracy[0] + 0.1 and res.avg_accuracy[-1] > 0.25
    assert res.final_accuracy() == res.avg_accuracy[-1]
    assert abs(res.total_comm_mb() - sum(res.comm_mb)) < 1e-9


def test_injected_init_params_and_payload(datasets):
    _, ds = datasets
    init = {n: np.asarray(v) for n, v in
            ref_cnn.mnist_cnn_init(jax.random.PRNGKey(3)).items()}
    cfg = simulator.SimulationConfig(num_vehicles=4, num_rsus=1, epochs=1,
                                     eval_samples=50, device="cpu")
    ctx = engine.build_context(cfg, dataset=ds, init_params=init)
    for n, v in init.items():
        assert ctx.setup.params_stack[n].shape == (5,) + v.shape
        np.testing.assert_array_equal(ctx.setup.params_stack[n][4].numpy(), v)
    assert engine.model_payload_bytes(ctx.setup.params_stack) == 21_840 * 4
    assert abs(engine.exchange_payload_mb(ctx) - (21_840 * 4 + 5 * 4) / 1e6) < 1e-12
    assert ctx.local_mask.tolist() == [1, 1, 1, 1, 0]
    assert float(ctx.target[-1]) == 0.0 and abs(float(ctx.target.sum()) - 1) < 1e-6
    picks = torch.zeros(5, cfg.local_steps, cfg.batch_size, dtype=torch.long)
    from repro_torch.data import pipeline
    x, y = pipeline.sample_batches(ctx.fed_data, None, cfg.local_steps,
                                   cfg.batch_size, picks=picks)
    assert x.shape == (5, 8, 80, 28, 28, 1) and y.shape == (5, 8, 80)
    first = ctx.fed_data.index_table[:, 0]
    assert torch.equal(y[:, 0, 0], ctx.fed_data.y[first])


def test_eval_schedule_and_window_defaults_match_reference():
    for epochs, every in [(7, 3), (10, 10), (5, 1)]:
        a = ref_engine.SimulationConfig(epochs=epochs, eval_every=every)
        b = engine.SimulationConfig(epochs=epochs, eval_every=every)
        np.testing.assert_array_equal(ref_engine._eval_mask(a, 2, 4), engine._eval_mask(b, 2, 4))
        for progress in (False, True):
            assert ref_engine._default_window(a, progress) == engine._default_window(b, progress)
    # same fields and defaults as the reference, but for the port's own two
    import dataclasses
    ref_fields = {f.name: f.default for f in dataclasses.fields(ref_engine.SimulationConfig)}
    own = {f.name: f.default for f in dataclasses.fields(engine.SimulationConfig)}
    assert own.pop("device") == "cuda"
    assert own.pop("mixing_backend") == "cuda" and ref_fields.pop("mixing_backend") == "jnp"
    assert own == ref_fields
