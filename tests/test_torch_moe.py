"""Port vs reference, ``models/moe``: the router (top-k, renormalised
weights, load-balance loss), the dense path (combine folded into the down
projection), the ragged path (stable sort by expert, one product per expert,
``index_add_`` back) and ``moe_ffn``'s dispatch on ``cfg.moe_impl``, on the
reference's MoE test config and on the reduced granite-moe-1b-a400m and
mixtral-8x7b. Weights come from the JAX package's ``init_moe``; inputs from
seeded numpy. Tolerance 1e-5 of the output's scale: the largest |difference|
is at most 1e-5 x max(1, max |reference|) (f32 on the CPU; the two
libraries' products sum in other orders, and the reference's expert init,
std E^-0.5, gives outputs in the hundreds at the presets' widths).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe

ATOL = 1e-5


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, tol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), max(1.0, np.abs(want).max())
    assert err <= tol * scale, f"max |diff| {err:.3e} > {tol:g} x {scale:.3e}"


def _cfgs(name, e=4, k=2):
    """(JAX config, torch config): the reference's test config, or a reduced preset."""
    if name == "test":
        kw = dict(name="t", family="moe", num_layers=1, d_model=16, num_heads=2,
                  num_kv_heads=2, head_dim=8, d_ff=32, vocab_size=100, num_experts=e,
                  top_k=k)
        return JaxArchConfig(**kw), ArchConfig(**kw)
    return jax_get_config(name).reduced(), get_config(name).reduced()


CASES = [("test", 4, 2), ("test", 8, 3), ("granite-moe-1b-a400m", 0, 0), ("mixtral-8x7b", 0, 0)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def case(request):
    name, e, k = request.param
    jcfg, cfg = _cfgs(name, e, k)
    jp = jmoe.init_moe(jax.random.PRNGKey(len(name) + e), jcfg)
    x = (0.5 * np.random.default_rng(e + k).normal(size=(48, cfg.d_model))).astype(np.float32)
    return jcfg, cfg, jp, {n: _t(v) for n, v in jp.items()}, x


def test_init_moe_matches_reference_layout():
    jcfg, cfg = _cfgs("test", 8, 2)
    want = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    got = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    stacked = moe.init_moe(torch.Generator().manual_seed(0), cfg, num_layers=3)
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == w.shape and stacked[name].shape == (3,) + w.shape
        # the reference's init_linear takes the leading axis as the fan-in
        np.testing.assert_allclose(float(got[name].std()), float(np.asarray(w).std()),
                                   rtol=0.25, err_msg=name)


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_router_topk_matches_reference(top_k):
    logits = np.random.default_rng(top_k).normal(size=(64, 8)).astype(np.float32)
    jw, jidx, jaux = jmoe.router_topk(logits, top_k)
    w, idx, aux = moe.router_topk(_t(logits), top_k)
    assert idx.tolist() == np.asarray(jidx).tolist()
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=ATOL)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=ATOL)


def test_balanced_router_aux_is_top_k():
    """Uniform probabilities: each expert routed k/E of the time at p = 1/E."""
    _, _, aux = moe.router_topk(torch.zeros((128, 4)), 2)
    assert abs(float(aux) - 2.0) < 1e-4


@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_moe_paths_match_reference(case, impl):
    jcfg, cfg, jp, tp, x = case
    jfn, fn = {"dense": (jmoe.moe_dense, moe.moe_dense),
               "ragged": (jmoe.moe_ragged, moe.moe_ragged)}[impl]
    want, jaux = jfn(jp, x, jcfg)
    got, aux = fn(tp, _t(x), cfg)
    assert got.shape == x.shape
    _close(got.numpy(), want)
    np.testing.assert_allclose(float(aux), float(jaux), atol=ATOL)


def test_ragged_equals_dense(case):
    _, cfg, _, tp, x = case
    dense, aux_d = moe.moe_dense(tp, _t(x), cfg)
    ragged, aux_r = moe.moe_ragged(tp, _t(x), cfg)
    _close(ragged.numpy(), dense.numpy())
    assert float(aux_r) == float(aux_d)


@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_moe_ffn_dispatches_on_moe_impl(case, impl, monkeypatch):
    """``moe_ffn`` on [B, S, d] against the reference's, and it calls the
    path ``cfg.moe_impl`` names."""
    jcfg, cfg, jp, tp, x = case
    jcfg, cfg = (dataclasses.replace(c, moe_impl=impl) for c in (jcfg, cfg))
    x3 = x.reshape(4, 12, -1)
    want, jaux = jmoe.moe_ffn(jp, x3, jcfg)
    called = []
    for name in ("moe_dense", "moe_ragged"):
        real = getattr(moe, name)
        monkeypatch.setattr(moe, name, lambda *a, _r=real, _n=name: called.append(_n) or _r(*a))
    got, aux = moe.moe_ffn(tp, _t(x3), cfg)
    assert called == [f"moe_{impl}"]
    assert got.shape == x3.shape
    _close(got.numpy(), want)
    np.testing.assert_allclose(float(aux), float(jaux), atol=ATOL)
