"""Port vs reference, ``repro_torch.optim``: ``sgd``, ``momentum`` (both
``nesterov`` values), ``adamw`` with and without weight decay over 3 steps,
the stacked ``[V]`` counter, the update taken one leaf at a time,
``global_norm``, ``clip_by_global_norm``, ``apply_updates`` and the four
schedules at counts 0, 1, in the warm-up, mid-way and past the total. Same
numpy inputs through ``repro.optim``; f32 atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim

ATOL = 1e-6
COUNTS = [0, 1, 5, 50, 99, 100, 150]


def _tree(seed, stacked=None):
    r = np.random.default_rng(seed)
    lead = () if stacked is None else (stacked,)
    return {"w": r.normal(size=lead + (7, 5)).astype(np.float32),
            "b": (0.1 * r.normal(size=lead + (5,))).astype(np.float32)}


def _t(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=ATOL)


def _run(port_opt, ref_opt, steps=3, stacked=None, weight=1.0):
    """``steps`` updates of both optimizers from the same parameters and
    gradients; returns both trajectories' last parameters and states."""
    params = _tree(0, stacked)
    p_params, j_params = _t(params), {k: jnp.asarray(v) for k, v in params.items()}
    p_state = port_opt.init(p_params, num_stacked=stacked)
    j_state = (ref_opt.init(j_params) if stacked is None
               else jax.vmap(ref_opt.init)(j_params))
    j_update = ref_opt.update if stacked is None else jax.vmap(ref_opt.update)
    for i in range(steps):
        grads = {k: weight * v for k, v in _tree(10 + i, stacked).items()}
        p_upd, p_state = port_opt.update(_t(grads), p_state, p_params)
        j_upd, j_state = j_update({k: jnp.asarray(v) for k, v in grads.items()}, j_state,
                                  j_params)
        _close(p_upd, j_upd)
        p_params = optim.apply_updates(p_params, p_upd)
        j_params = jopt.apply_updates(j_params, j_upd)
    _close(p_params, j_params)
    return p_state, j_state


@pytest.mark.parametrize("lr", [0.05, "sched"])
def test_sgd_matches_reference(lr):
    p_lr = optim.schedules.inverse_sqrt(0.05, 2) if lr == "sched" else lr
    j_lr = jopt.schedules.inverse_sqrt(0.05, 2) if lr == "sched" else lr
    state, _ = _run(optim.sgd(p_lr), jopt.sgd(j_lr))
    assert int(state.count) == 3


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_matches_reference(nesterov):
    p_state, j_state = _run(optim.momentum(0.05, 0.9, nesterov), jopt.momentum(0.05, 0.9, nesterov))
    assert int(p_state.count) == 3
    _close(p_state.momentum, j_state.momentum)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("weight", [1.0, 1e-6])
def test_adamw_matches_reference_over_three_steps(weight_decay, weight):
    p_state, j_state = _run(optim.adamw(1e-3, weight_decay=weight_decay),
                            jopt.adamw(1e-3, weight_decay=weight_decay), weight=weight)
    assert p_state.count.dtype == torch.int32 and int(p_state.count) == 3
    _close(p_state.mu, j_state.mu)
    _close(p_state.nu, j_state.nu)


@pytest.mark.parametrize("make", ["adamw", "momentum", "sgd_schedule"])
def test_stacked_counter_matches_vmapped_reference(make):
    """``init(..., num_stacked=V)``: a ``[V]`` counter, each row updated as
    the reference's vmapped optimizer updates it."""
    port, ref = {"adamw": (optim.adamw(optim.schedules.cosine(1e-3, 2, 10)),
                           jopt.adamw(jopt.schedules.cosine(1e-3, 2, 10))),
                 "momentum": (optim.momentum(optim.schedules.step_decay(0.1, 0.5, 2), 0.8),
                              jopt.momentum(jopt.schedules.step_decay(0.1, 0.5, 2), 0.8)),
                 "sgd_schedule": (optim.sgd(optim.schedules.cosine(0.1, 1, 4)),
                                  jopt.sgd(jopt.schedules.cosine(0.1, 1, 4)))}[make]
    p_state, j_state = _run(port, ref, stacked=3)
    assert p_state.count.tolist() == [3, 3, 3]
    np.testing.assert_array_equal(p_state.count.numpy(), np.asarray(j_state.count))


def test_adamw_one_leaf_at_a_time_equals_the_whole_tree():
    opt = optim.adamw(1e-3, weight_decay=0.05)
    params = _t(_tree(0, 3))
    state = opt.init(params, num_stacked=3)
    state = state._replace(count=torch.tensor([0, 2, 5], dtype=torch.int32))
    grads = _t(_tree(1, 3))
    whole, new = opt.update(grads, state, params)
    for name in params:
        for v in range(3):
            one, st = opt.update({name: grads[name][v]},
                                 optim.AdamState(state.count[v], {name: state.mu[name][v]},
                                                 {name: state.nu[name][v]}),
                                 {name: params[name][v]})
            torch.testing.assert_close(one[name], whole[name][v], rtol=0, atol=0)
            torch.testing.assert_close(st.mu[name], new.mu[name][v], rtol=0, atol=0)


def test_global_norm_clip_and_apply_updates_match_reference():
    tree = _tree(4)
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    norm = float(optim.global_norm(_t(tree)))
    assert norm == pytest.approx(float(jopt.global_norm(jtree)), abs=ATOL)
    for max_norm in (0.5 * norm, 2.0 * norm):
        _close(optim.clip_by_global_norm(_t(tree), max_norm),
               jopt.clip_by_global_norm(jtree, max_norm))
    half = {k: torch.as_tensor(v).to(torch.bfloat16) for k, v in tree.items()}
    upd = _t(_tree(5))
    got = optim.apply_updates(half, upd)
    want = jopt.apply_updates({k: jnp.asarray(v, jnp.bfloat16) for k, v in tree.items()},
                              {k: jnp.asarray(v) for k, v in _tree(5).items()})
    for k in got:
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k]).astype(np.float32))


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)), ("cosine", (1e-3, 10, 100)), ("cosine", (1e-3, 10, 100, 1e-5)),
    ("cosine", (1e-3, 0, 100)), ("inverse_sqrt", (1e-3, 10)), ("inverse_sqrt", (1e-3, 0)),
    ("step_decay", (0.1, 0.5, 30)),
])
def test_schedules_match_reference(name, args):
    port, ref = getattr(optim.schedules, name)(*args), getattr(jopt.schedules, name)(*args)
    counts = np.asarray(COUNTS, np.int32)
    got = port(torch.as_tensor(counts))
    assert got.dtype == torch.float32 and got.shape == counts.shape
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(np.asarray(ref(jnp.asarray(counts))),
                                                            counts.shape), rtol=0, atol=ATOL)
    for c in (0, 1, 77):                    # a scalar count gives a scalar
        one = port(torch.tensor(c, dtype=torch.int32))
        assert one.shape == () and float(one) == pytest.approx(float(ref(jnp.int32(c))),
                                                               abs=ATOL)
