"""Port vs reference, local training: the two paper CNNs' forward with
converted weights, parameter counts, and E local SGD steps with injected
batches and dropout off.

Tolerance atol 1e-5 throughout: the same f32 arithmetic with sums taken in
another order (im2col + batched matmul on both sides; a few hundred terms
per output at O(1) magnitudes), and over E <= 3 SGD steps at lr 0.1 the
difference does not grow past it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fed import engine as ref_engine
from repro.models import cnn as ref_cnn
from repro.optim import sgd as ref_sgd
from repro_torch import convert
from repro_torch.fed import engine
from repro_torch.models import cnn
from repro_torch.optim import apply_updates, sgd

NETS = {
    "mnist": (ref_cnn.mnist_cnn_init, ref_cnn.mnist_cnn_apply, cnn.mnist_cnn_apply,
              (28, 28, 1), 21_840),
    "cifar10": (ref_cnn.cifar_cnn_init, ref_cnn.cifar_cnn_apply, cnn.cifar_cnn_apply,
                (32, 32, 3), 33_834),
}


def _ref_params(kind, seed, k=None):
    """Reference-initialised params as numpy: one set, or k distinct sets
    stacked [k, ...]."""
    init = NETS[kind][0]
    if k is None:
        return {n: np.asarray(v) for n, v in init(jax.random.PRNGKey(seed)).items()}
    sets = [init(jax.random.PRNGKey(seed + i)) for i in range(k)]
    r = np.random.default_rng(seed)
    return {n: np.stack([np.asarray(s[n]) for s in sets])
            + (0.05 * r.normal(size=(k,) + sets[0][n].shape)).astype(np.float32)
            for n in sets[0]}


@pytest.mark.parametrize("kind", ["mnist", "cifar10"])
def test_param_counts_exact(kind):
    _, _, _, _, count = NETS[kind]
    init_fn, _, _ = cnn.make_cnn_task(kind)
    params = init_fn(torch.Generator().manual_seed(0))
    assert cnn.count_params(params) == count
    ref = _ref_params(kind, 0)
    assert {n: tuple(p.shape) for n, p in params.items()} == {n: v.shape for n, v in ref.items()}
    assert cnn.count_params(convert.params_from_numpy(ref)) == count


@pytest.mark.parametrize("kind", ["mnist", "cifar10"])
def test_forward_single_matches_reference(kind):
    _, ref_apply, apply, shape, _ = NETS[kind]
    params = _ref_params(kind, 1)
    x = np.random.default_rng(1).random((5,) + shape).astype(np.float32)
    want = np.asarray(ref_apply({n: jnp.asarray(v) for n, v in params.items()}, jnp.asarray(x)))
    got = apply(convert.params_from_numpy(params), torch.as_tensor(x))
    assert got.shape == (5, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("kind", ["mnist", "cifar10"])
def test_forward_stacked_matches_vmapped_reference(kind):
    _, ref_apply, apply, shape, _ = NETS[kind]
    k = 3
    params = _ref_params(kind, 2, k=k)
    x = np.random.default_rng(2).random((k, 4) + shape).astype(np.float32)
    want = np.asarray(jax.vmap(ref_apply)(
        {n: jnp.asarray(v) for n, v in params.items()}, jnp.asarray(x)))
    got = apply(convert.params_from_numpy(params), torch.as_tensor(x))
    assert got.shape == (k, 4, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    with pytest.raises(ValueError):
        apply(convert.params_from_numpy(params), torch.as_tensor(x[0]))


def test_dropout_takes_a_mask_or_a_generator_and_train_false_turns_it_off():
    params = convert.params_from_numpy(_ref_params("mnist", 3))
    x = torch.as_tensor(np.random.default_rng(3).random((6, 28, 28, 1)).astype(np.float32))
    base = cnn.mnist_cnn_apply(params, x)
    ones = torch.ones(1, 6, 50)
    # train=False ignores mask and generator
    g = torch.Generator().manual_seed(0)
    assert torch.equal(cnn.mnist_cnn_apply(params, x, dropout_mask=ones * 0, generator=g,
                                           train=False), base)
    # train=True with neither passes through (the reference's rng=None case)
    assert torch.equal(cnn.mnist_cnn_apply(params, x, train=True), base)
    # an all-zero keep mask leaves only the last layer's bias
    dropped = cnn.mnist_cnn_apply(params, x, dropout_mask=ones * 0, train=True)
    want = torch.log_softmax(params["fc2_b"], dim=-1).expand(6, 10)
    np.testing.assert_allclose(dropped.numpy(), want.numpy(), atol=1e-6)
    # a generator draws a mask: output changes, and is reproducible per seed
    a = cnn.mnist_cnn_apply(params, x, generator=torch.Generator().manual_seed(1), train=True)
    b = cnn.mnist_cnn_apply(params, x, generator=torch.Generator().manual_seed(1), train=True)
    assert torch.equal(a, b) and not torch.allclose(a, base)


def test_nll_loss_and_accuracy_match_reference():
    r = np.random.default_rng(4)
    lp = np.log(r.dirichlet(np.ones(10), size=(3, 7))).astype(np.float32)
    y = r.integers(0, 10, size=(3, 7)).astype(np.int32)
    want = np.asarray(jax.vmap(ref_cnn.nll_loss)(jnp.asarray(lp), jnp.asarray(y)))
    np.testing.assert_allclose(cnn.nll_loss(torch.as_tensor(lp), torch.as_tensor(y)).numpy(),
                               want, atol=1e-6)
    np.testing.assert_allclose(
        float(cnn.nll_loss(torch.as_tensor(lp[0]), torch.as_tensor(y[0]))), want[0], atol=1e-6)
    params = _ref_params("mnist", 5, k=3)
    x = r.random((3, 20, 28, 28, 1)).astype(np.float32)
    yy = r.integers(0, 10, size=(3, 20)).astype(np.int32)
    _, _, ref_acc = ref_cnn.make_cnn_task("mnist")
    _, _, acc = cnn.make_cnn_task("mnist")
    want = np.asarray(jax.vmap(ref_acc)({n: jnp.asarray(v) for n, v in params.items()},
                                        jnp.asarray(x), jnp.asarray(yy)))
    got = acc(convert.params_from_numpy(params), torch.as_tensor(x), torch.as_tensor(yy).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    with pytest.raises(ValueError):
        cnn.make_cnn_task("imagenet")


@pytest.mark.parametrize("kind,k,e,b", [("mnist", 3, 3, 6), ("cifar10", 2, 2, 4)])
def test_local_training_matches_reference(kind, k, e, b):
    """E SGD steps for K vehicles, same initial weights and batches, dropout
    off on both sides: loss and post-step parameters agree."""
    _, ref_apply, apply, shape, _ = NETS[kind]
    lr = 0.1
    params = _ref_params(kind, 6, k=k)
    r = np.random.default_rng(6)
    xs = r.random((k, e, b) + shape).astype(np.float32)
    ys = r.integers(0, 10, size=(k, e, b)).astype(np.int32)

    def ref_loss(p, x, y, rng):
        return ref_cnn.nll_loss(ref_apply(p, x, rng=None, train=False), y)

    opt = ref_sgd(lr)
    ref_train = ref_engine.make_local_train_fn(ref_loss, opt)
    pj = {n: jnp.asarray(v) for n, v in params.items()}
    want_p, want_s, want_m = jax.vmap(ref_train)(
        pj, jax.vmap(opt.init)(pj), (jnp.asarray(xs), jnp.asarray(ys)),
        jax.random.split(jax.random.PRNGKey(0), k))

    def loss(p, x, y, generator=None):
        return cnn.nll_loss(apply(p, x, train=False), y)

    topt = sgd(lr)
    train = engine.make_local_train_fn(loss, topt)
    pt = convert.params_from_numpy(params)
    got_p, got_s, got_m = train(pt, topt.init(pt, num_stacked=k),
                                (torch.as_tensor(xs), torch.as_tensor(ys).long()), None)
    np.testing.assert_allclose(got_m["loss"].numpy(), np.asarray(want_m["loss"]), atol=1e-5)
    for n in params:
        assert got_p[n].shape == params[n].shape and not got_p[n].requires_grad
        np.testing.assert_allclose(got_p[n].numpy(), np.asarray(want_p[n]), atol=1e-5)
        # it did train: the weights moved
        assert np.abs(got_p[n].numpy() - params[n]).max() > 1e-6
    np.testing.assert_array_equal(got_s.count.numpy(), np.asarray(want_s.count))
    assert got_s.count.dtype == torch.int32


def test_sgd_and_apply_updates_match_reference():
    r = np.random.default_rng(7)
    p = {"w": r.normal(size=(4, 3)).astype(np.float32)}
    g = {"w": r.normal(size=(4, 3)).astype(np.float32)}
    from repro.optim import apply_updates as ref_apply_updates
    ro = ref_sgd(0.05)
    ru, rs = ro.update({"w": jnp.asarray(g["w"])}, ro.init(p))
    to = sgd(0.05)
    tu, ts = to.update(convert.params_from_numpy(g), to.init(convert.params_from_numpy(p)))
    np.testing.assert_allclose(tu["w"].numpy(), np.asarray(ru["w"]), atol=1e-7)
    assert int(ts.count) == int(rs.count) == 1
    np.testing.assert_allclose(
        apply_updates(convert.params_from_numpy(p), tu)["w"].numpy(),
        np.asarray(ref_apply_updates({"w": jnp.asarray(p["w"])}, ru)["w"]), atol=1e-7)


def test_convert_round_trip():
    params = _ref_params("mnist", 8, k=2)
    state = convert.federation_state_from_numpy(
        params, np.array([3, 3], np.int32), np.eye(2, dtype=np.float32), np.int32(3))
    back = convert.to_numpy(state)
    assert type(back).__name__ == "FederationState"
    for n in params:
        np.testing.assert_array_equal(back.params[n], params[n])
    np.testing.assert_array_equal(back.opt_state.count, [3, 3])
    np.testing.assert_array_equal(back.state_matrix, np.eye(2))
    assert int(back.epoch) == 3
