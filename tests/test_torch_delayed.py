"""Delayed gossip in the port against the reference: the vehicle-axis
functions (``mixing_self_weight``, ``zero_self_weight``,
``delayed_gossip_mix``) in both contact formats, one injected delayed round of
``dds``, the W = I anchor (bit for bit, every algorithm), delayed against
sync, and what ``check_supported`` now takes.

Tolerances are the reference's: f32 atol 1e-5.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as ref_aggregation
from repro.core import contacts as ref_contacts
from repro.core import dfl_dds as ref_dds
from repro.core import vehicle_axis as ref_va
from repro.fed import engine as ref_engine
from repro.fed import topology as ref_topo
from repro.models import cnn as ref_cnn
from repro.optim import sgd as ref_sgd
from repro_torch import convert
from repro_torch.core import aggregation, contacts, dfl_dds, vehicle_axis
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.fed import algorithms, engine, simulator
from repro_torch.kernels.gossip_mix import mix_params_cuda
from repro_torch.models import cnn
from repro_torch.optim import sgd

T = torch.as_tensor


@pytest.fixture(scope="module")
def tiny_ds():
    return synthetic_mnist(n_train=1200, n_test=200)


def _cfg(**kw):
    base = dict(algorithm="dds", num_vehicles=6, epochs=4, eval_every=2,
                eval_samples=200, local_steps=2, batch_size=16, p1_steps=20,
                lr=0.15, comm_range=250.0, device="cpu")
    base.update(kw)
    return simulator.SimulationConfig(**base)


def _contacts(k, seed, p=0.5):
    r = np.random.default_rng(seed)
    c = np.triu(r.random((k, k)) < p, 1)
    return (c | c.T | np.eye(k, dtype=bool)).astype(np.float32)


def _mixings(k, seed, sparse):
    """A row-stochastic mixing on a random contact graph, as (reference,
    port) objects; sparse: a neighbour list with two spare padding slots."""
    c = _contacts(k, seed)
    r = np.random.default_rng(seed + 1)
    w = c * r.random((k, k)).astype(np.float32)
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    if not sparse:
        return jnp.asarray(w), T(w)
    idx, mask = ref_topo.neighbour_lists(c, int(c.sum(1).max()) + 2)
    ws = np.take_along_axis(w, idx, axis=1) * mask
    return (ref_contacts.SparseMixing(jnp.asarray(idx), jnp.asarray(ws)),
            contacts.SparseMixing(T(idx), T(ws)))


# ------------------------------------------------- the vehicle-axis functions

@pytest.mark.parametrize("sparse", [False, True])
def test_self_weight_and_neighbour_only_mixing_match_reference(sparse):
    mix_j, mix_t = _mixings(7, 3, sparse)
    np.testing.assert_allclose(vehicle_axis.mixing_self_weight(mix_t).numpy(),
                               np.asarray(ref_va.mixing_self_weight(mix_j)), atol=0)
    got, want = vehicle_axis.zero_self_weight(mix_t), ref_va.zero_self_weight(mix_j)
    if sparse:
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        got, want = got.w, want.w
        rows = contacts.mixing_to_dense(vehicle_axis.zero_self_weight(mix_t))
    else:
        rows = got.numpy()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0)
    # neighbour-only rows: zero diagonal, each row below one
    assert np.all(np.diag(rows) == 0) and np.all(rows.sum(-1) < 1)


@pytest.mark.parametrize("sparse", [False, True])
def test_vehicle_axis_functions_take_a_seed_axis(sparse):
    pairs = [_mixings(6, s, sparse)[1] for s in (0, 1, 2)]
    if sparse:
        d = max(m.idx.shape[1] for m in pairs)
        padded = [contacts.pad_slots(contacts.SparseContacts(m.idx, m.w), d) for m in pairs]
        stacked = contacts.SparseMixing(T(np.stack([p.idx for p in padded])),
                                        T(np.stack([p.mask for p in padded])))
    else:
        stacked = torch.stack(pairs)
    self_w = vehicle_axis.mixing_self_weight(stacked)
    for s, m in enumerate(pairs):
        np.testing.assert_array_equal(self_w[s].numpy(),
                                      vehicle_axis.mixing_self_weight(m).numpy())
        zs = vehicle_axis.zero_self_weight(stacked)
        z1 = vehicle_axis.zero_self_weight(m)
        if sparse:
            np.testing.assert_array_equal(contacts.mixing_to_dense(
                contacts.SparseMixing(zs.idx[s], zs.w[s])), contacts.mixing_to_dense(z1))
        else:
            np.testing.assert_array_equal(zs[s].numpy(), z1.numpy())


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("mix", ["torch", "cuda"])
def test_delayed_gossip_mix_matches_reference(sparse, mix):
    """Injected params and stale buffer through both stacks' delayed mix;
    the port's plain mix and its kernels' CPU route alike."""
    k = 7
    mix_j, mix_t = _mixings(k, 5, sparse)
    r = np.random.default_rng(2)
    params = {"a": r.normal(size=(k, 3, 4)).astype(np.float32),
              "b": r.normal(size=(k, 5)).astype(np.float32)}
    stale = {n: r.normal(size=v.shape).astype(np.float32) for n, v in params.items()}
    want = ref_va.delayed_gossip_mix(ref_aggregation.mix_params, ref_va.GLOBAL)(
        mix_j, {n: jnp.asarray(v) for n, v in params.items()},
        {n: jnp.asarray(v) for n, v in stale.items()})
    base = aggregation.mix_params if mix == "torch" else mix_params_cuda
    got = vehicle_axis.delayed_gossip_mix(base)(
        mix_t, {n: T(v) for n, v in params.items()}, {n: T(v) for n, v in stale.items()})
    for n in params:
        assert got[n].shape == params[n].shape
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]), atol=1e-5)


@pytest.mark.parametrize("sparse", [False, True])
def test_delayed_mix_identity_is_bitwise_the_sync_mix(sparse):
    """W = I: the neighbour term is exactly zero, the self weight exactly one."""
    k = 6
    r = np.random.default_rng(4)
    params = {"w": T(r.normal(size=(k, 9)).astype(np.float32))}
    stale = {"w": T(r.normal(size=(k, 9)).astype(np.float32))}
    if sparse:
        idx, mask = ref_topo.neighbour_lists(np.eye(k, dtype=np.float32), 3)
        mixing = aggregation.uniform_mixing(contacts.SparseContacts(T(idx), T(mask)))
    else:
        mixing = torch.eye(k)
    out = vehicle_axis.delayed_gossip_mix(mix_params_cuda)(mixing, params, stale)
    assert torch.equal(out["w"], params["w"])
    assert torch.equal(out["w"], mix_params_cuda(mixing, params)["w"])


# --------------------------------------------------- one injected delayed round

@pytest.mark.parametrize("sparse", [False, True])
def test_one_delayed_dds_round_matches_reference(sparse):
    """One ``dds`` round under delayed gossip, both stacks from the same
    injected federation state, stale buffer and batches (dropout off)."""
    k, e, b, lr, steps = 5, 2, 6, 0.1, 30
    r = np.random.default_rng(11)
    init = ref_cnn.mnist_cnn_init(jax.random.PRNGKey(0))
    params = {n: np.stack([np.asarray(v)] * k)
              + (0.05 * r.normal(size=(k,) + v.shape)).astype(np.float32)
              for n, v in init.items()}
    stale = {n: (v + 0.05 * r.normal(size=v.shape)).astype(np.float32)
             for n, v in params.items()}
    c = _contacts(k, 7)
    state = r.dirichlet(np.ones(k), size=k).astype(np.float32)
    counts = np.array([5, 9, 3, 7, 4], np.float32)
    target = counts / counts.sum()
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
    jparams = {n: jnp.asarray(v) for n, v in params.items()}
    fed_j = ref_dds.FederationState(
        jparams, jax.vmap(opt.init)(jparams)._replace(count=jnp.asarray(count0)),
        jnp.asarray(state), jnp.asarray(7, jnp.int32))
    ref_delayed = ref_va.delayed_gossip_mix(ref_aggregation.mix_params, ref_va.GLOBAL)
    stale_j = {n: jnp.asarray(v) for n, v in stale.items()}
    want, want_d = ref_dds.dds_round(
        fed_j, cj, jnp.asarray(target), (jnp.asarray(xs), jnp.asarray(ys)),
        jax.random.PRNGKey(1), ref_engine.make_local_train_fn(ref_loss, opt),
        lr=lr, local_steps=e, p1_steps=steps, p1_step_size=2.0,
        mix_params_fn=lambda w, p: ref_delayed(w, p, stale_j))

    def loss(p, x, y, generator=None):
        return cnn.nll_loss(cnn.mnist_cnn_apply(p, x, train=False), y)

    delayed = vehicle_axis.delayed_gossip_mix(mix_params_cuda)
    stale_t = {n: T(v) for n, v in stale.items()}
    fed_t = convert.federation_state_from_numpy(params, count0, state, 7)
    got, got_d = dfl_dds.dds_round(
        fed_t, ct, T(target), (T(xs), T(ys).long()), None,
        engine.make_local_train_fn(loss, sgd(lr)),
        lr=lr, local_steps=e, p1_steps=steps, p1_step_size=2.0,
        mix_params_fn=lambda w, p: delayed(w, p, stale_t))
    for n in params:
        np.testing.assert_allclose(got.params[n].numpy(), np.asarray(want.params[n]),
                                   atol=1e-5)
    np.testing.assert_allclose(got.state_matrix.numpy(), np.asarray(want.state_matrix),
                               atol=1e-5)
    for name in ("kl_divergence", "entropy", "loss"):
        np.testing.assert_allclose(got_d[name].numpy(), np.asarray(want_d[name]), atol=1e-5)


def test_engine_delayed_round_carries_the_sent_payload(tiny_ds):
    """The window's carry is (algorithm state, stale params); after a round
    the buffer is what the algorithm put on the air — the mix input."""
    cfg = _cfg(overlap="delayed", epochs=1)
    ctx = engine.build_context(cfg, dataset=tiny_ds)
    algo_state, stale = ctx.init_state
    for n, leaf in ctx.setup.params_stack.items():
        assert torch.equal(stale[n], leaf)
    engine.run_with_context(ctx)
    final, buffer = ctx.final_state
    assert set(buffer) == set(final.params)
    # dds mixes before training: the buffer is the pre-mix params of round 0
    for n in buffer:
        assert torch.equal(buffer[n], ctx.setup.params_stack[n])


# ------------------------------------------------------- whole runs, anchors

@pytest.mark.parametrize("algorithm", ["dds", "dfl", "sp", "d_sgd", "d_fedavg"])
def test_delayed_gossip_identity_anchor_is_bitwise(tiny_ds, algorithm):
    """p_drop = 1 -> W = I every round: delayed == sync bit for bit."""
    cfg = _cfg(algorithm=algorithm, p_drop=1.0, epochs=3, eval_every=3)
    sync = simulator.run_simulation(cfg, dataset=tiny_ds)
    late = simulator.run_simulation(replace(cfg, overlap="delayed"), dataset=tiny_ds)
    np.testing.assert_array_equal(late.avg_accuracy, sync.avg_accuracy)
    np.testing.assert_array_equal(late.vehicle_accuracy, sync.vehicle_accuracy)
    np.testing.assert_array_equal(late.consensus_distance, sync.consensus_distance)
    np.testing.assert_array_equal(late.kl_trace, sync.kl_trace)


@pytest.mark.parametrize("contact_format", ["sparse", "dense"])
def test_delayed_follows_reference_trajectory(tiny_ds, contact_format):
    """The deterministic traces of a delayed run equal the reference's (the
    state vectors do not see the stale params), and the run learns."""
    from repro.data.synthetic import synthetic_mnist as ref_synthetic_mnist
    from repro.fed import simulator as ref_sim

    base = dict(num_vehicles=6, epochs=4, eval_every=2, eval_samples=200,
                local_steps=2, batch_size=16, p1_steps=20, lr=0.15,
                comm_range=250.0, contact_format=contact_format, overlap="delayed")
    want = ref_sim.run_simulation(ref_sim.SimulationConfig(**base),
                                  dataset=ref_synthetic_mnist(n_train=1200, n_test=200))
    got = simulator.run_simulation(simulator.SimulationConfig(**base, device="cpu"),
                                   dataset=tiny_ds)
    np.testing.assert_allclose(got.kl_trace, want.kl_trace, atol=1e-5)
    np.testing.assert_allclose(got.comm_mb, want.comm_mb, atol=1e-5)
    np.testing.assert_allclose(np.stack(got.entropy), np.stack(want.entropy), atol=1e-5)
    assert np.isfinite(got.avg_accuracy).all() and sum(got.comm_mb) > 0


def test_delayed_differs_from_sync_with_live_contacts(tiny_ds):
    cfg = _cfg(epochs=4, eval_every=2)
    sync = simulator.run_simulation(cfg, dataset=tiny_ds)
    late = simulator.run_simulation(replace(cfg, overlap="delayed"), dataset=tiny_ds)
    assert np.isfinite(late.final_accuracy())
    assert not np.array_equal(late.avg_accuracy, sync.avg_accuracy)
    np.testing.assert_array_equal(late.kl_trace, sync.kl_trace)   # same P1, same contacts


def test_delayed_gossip_requires_scan_engine(tiny_ds):
    cfg = _cfg(overlap="delayed", use_scan_engine=False)
    with pytest.raises(ValueError, match="scan engine"):
        simulator.run_simulation(cfg, dataset=tiny_ds)


def test_check_supported_takes_this_slice_and_names_the_next():
    engine.check_supported(_cfg(overlap="delayed"))
    engine.check_supported(_cfg(use_scan_engine=False))
    engine.check_supported(_cfg(execution="auto"))
    with pytest.raises(ValueError, match="manual|auto"):
        engine.check_supported(_cfg(execution="nope"))
    with pytest.raises(ValueError, match="delayed"):
        engine.check_supported(_cfg(overlap="nope"))
    assert "dds" in algorithms.available_algorithms()
