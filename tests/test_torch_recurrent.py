"""Port vs reference, the recurrent mixers: ``models/rwkv6`` (time-mix in
its chunked form across chunk boundaries and from a carried state, the
one-token decode, channel-mix, padded heads) and ``models/ssm`` (the causal
conv, the in-chunk doubling scan against the reference's
``associative_scan``, ``ssm_forward`` across chunk boundaries and from a
carried state, ``ssm_decode``). Weights come from the JAX package's init
functions with every constant leaf moved off its constant; inputs from seeded
numpy; atol 1e-5 (f32 on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.models import rwkv6 as jrwkv6
from repro.models import ssm as jssm
from repro_torch.configs.base import ArchConfig
from repro_torch.models import rwkv6, ssm

ATOL = 1e-5
CONSTANT_LEAVES = ("mix_mu", "mix_k", "mix_r", "decay_w0", "ln_x",
                   "conv_b", "dt_bias", "log_a", "d_skip")


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _both(**kw):
    return JaxArchConfig(**kw), ArchConfig(**kw)


def _rwkv_cfgs(heads=None):
    return _both(name="t", family="ssm", num_layers=1, d_model=32, num_heads=heads or 4,
                 num_kv_heads=0, head_dim=8, d_ff=64, vocab_size=100, attn_free=True)


def _ssm_cfgs():
    return _both(name="t", family="hybrid", num_layers=1, d_model=24, num_heads=2,
                 num_kv_heads=1, head_dim=8, d_ff=64, vocab_size=100, ssm_state=4,
                 hybrid=True)


def _params(jax_params, seed):
    """(JAX params, torch params): the constant leaves perturbed."""
    r = np.random.default_rng(seed)
    out = {}
    for name, v in jax_params.items():
        v = np.asarray(v)
        if name in CONSTANT_LEAVES:
            v = (v + 0.1 * r.normal(size=v.shape)).astype(np.float32)
        out[name] = v
    return {n: jnp.asarray(v) for n, v in out.items()}, {n: _t(v) for n, v in out.items()}


def _x(shape, seed, scale=0.5):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


# -------------------------------------------------------------- rwkv6 ----

@pytest.fixture(scope="module", params=[None, 6], ids=["heads4", "inner-width48"])
def rwkv(request):
    jcfg, cfg = _rwkv_cfgs(request.param)
    jp, tp = _params(jrwkv6.init_time_mix(jax.random.PRNGKey(0), jcfg), 1)
    return jcfg, cfg, jp, tp


def _rwkv_state(cfg, b, seed):
    h = rwkv6.num_heads(cfg)
    return {"shift": _x((b, cfg.d_model), seed),
            "wkv": _x((b, h, cfg.head_dim, cfg.head_dim), seed + 1)}


@pytest.mark.parametrize("chunk,s,carried", [(8, 20, False), (8, 20, True), (64, 20, False),
                                             (4, 13, True)])
def test_time_mix_matches_reference(rwkv, chunk, s, carried):
    """Chunk 8 at S=20: two whole chunks and a partial one on both sides."""
    jcfg, cfg, jp, tp = rwkv
    x = _x((2, s, cfg.d_model), s)
    st = _rwkv_state(cfg, 2, 7) if carried else None
    want, wstate = jrwkv6.time_mix(jp, x, jcfg, state=st, chunk=chunk)
    got, gstate = rwkv6.time_mix(tp, _t(x), cfg, chunk=chunk,
                                 state=None if st is None else {n: _t(v) for n, v in st.items()})
    _close(got.numpy(), want)
    _close(gstate["wkv"].numpy(), wstate["wkv"])
    _close(gstate["shift"].numpy(), wstate["shift"])


def test_time_mix_decode_matches_reference(rwkv):
    jcfg, cfg, jp, tp = rwkv
    st = _rwkv_state(cfg, 3, 11)
    x = _x((3, 1, cfg.d_model), 12)
    want, wstate = jrwkv6.time_mix_decode(jp, x, jcfg, st)
    got, gstate = rwkv6.time_mix_decode(tp, _t(x), cfg, {n: _t(v) for n, v in st.items()})
    _close(got.numpy(), want)
    _close(gstate["wkv"].numpy(), wstate["wkv"])
    _close(gstate["shift"].numpy(), wstate["shift"])


def test_time_mix_chunked_equals_decode(rwkv):
    """The port's chunked form against its own recurrent steps (the
    reference's own check, its tolerance 1e-4)."""
    _, cfg, _, tp = rwkv
    x = _t(_x((2, 19, cfg.d_model), 3))
    y_chunk, st_chunk = rwkv6.time_mix(tp, x, cfg, chunk=8)
    h = rwkv6.num_heads(cfg)
    state = {"shift": torch.zeros((2, cfg.d_model)),
             "wkv": torch.zeros((2, h, cfg.head_dim, cfg.head_dim))}
    ys = []
    for t in range(19):
        y, state = rwkv6.time_mix_decode(tp, x[:, t:t + 1], cfg, state)
        ys.append(y)
    _close(y_chunk, torch.cat(ys, 1), atol=1e-4)
    _close(st_chunk["wkv"], state["wkv"], atol=1e-4)


def test_channel_mix_matches_reference():
    jcfg, cfg = _rwkv_cfgs()
    jp, tp = _params(jrwkv6.init_channel_mix(jax.random.PRNGKey(2), jcfg), 3)
    x, prev = _x((2, 5, 32), 4), _x((2, 32), 5)
    want, wshift = jrwkv6.channel_mix(jp, x, prev)
    got, gshift = rwkv6.channel_mix(tp, _t(x), _t(prev))
    _close(got.numpy(), want)
    assert np.array_equal(gshift.numpy(), np.asarray(wshift))


def test_rwkv_init_matches_reference_layout():
    jcfg, cfg = _rwkv_cfgs(heads=6)              # inner width 48 != d_model 32
    for jfn, fn in ((jrwkv6.init_time_mix, rwkv6.init_time_mix),
                    (jrwkv6.init_channel_mix, rwkv6.init_channel_mix)):
        want = jfn(jax.random.PRNGKey(0), jcfg)
        got = fn(torch.Generator().manual_seed(0), cfg)
        stacked = fn(torch.Generator().manual_seed(0), cfg, num_layers=2)
        assert set(got) == set(want)
        for name, w in want.items():
            assert got[name].shape == w.shape and stacked[name].shape == (2,) + w.shape
    padded = _rwkv_cfgs()[1].pad_for_mesh(3)    # 4 heads padded to 6
    assert (padded.true_num_heads, padded.num_heads) == (4, 6)
    tm = rwkv6.init_time_mix(torch.Generator().manual_seed(0), padded, num_layers=2)
    true_w = padded.true_num_heads * padded.head_dim
    assert (tm["wo"][:, true_w:] == 0).all() and (tm["wo"][:, :true_w] != 0).any()
    assert (tm["decay_w0"] == -6.0).all() and (tm["mix_mu"] == 0.5).all()


# ---------------------------------------------------------------- ssm ----

@pytest.fixture(scope="module")
def hybrid():
    jcfg, cfg = _ssm_cfgs()
    jp, tp = _params(jssm.init_ssm(jax.random.PRNGKey(0), jcfg), 2)
    return jcfg, cfg, jp, tp


def _ssm_state(cfg, b, seed):
    return {"conv": _x((b, ssm.CONV_K - 1, cfg.d_model), seed),
            "h": _x((b, cfg.d_model, cfg.ssm_state), seed + 1)}


def test_causal_conv_matches_reference():
    x, w, b, st = _x((2, 9, 24), 0), _x((ssm.CONV_K, 24), 1), _x((24,), 2), _x((2, 3, 24), 3)
    want, wst = jssm._causal_conv(x, w, b, st)
    got, gst = ssm._causal_conv(*map(_t, (x, w, b, st)))
    _close(got.numpy(), want)
    assert np.array_equal(gst.numpy(), np.asarray(wst))


@pytest.mark.parametrize("c", [1, 2, 13, 16, 128])
def test_scan_chunk_matches_associative_scan(c):
    """The doubling scan against ``jax.lax.associative_scan`` on decays in
    (0, 1): every prefix, powers of two and not."""
    r = np.random.default_rng(c)
    log_decay = -r.uniform(0.0, 0.5, size=(2, c, 5, 3)).astype(np.float32)
    u = r.normal(size=(2, c, 5, 3)).astype(np.float32)
    h0 = r.normal(size=(2, 5, 3)).astype(np.float32)
    want_all, want_last = jssm._scan_chunk(*map(jnp.asarray, (h0, log_decay, u)))
    got_all, got_last = ssm._scan_chunk(*map(_t, (h0, log_decay, u)))
    _close(got_all.numpy(), want_all)
    _close(got_last.numpy(), want_last)


@pytest.mark.parametrize("chunk,s,carried", [(8, 20, False), (8, 20, True), (128, 20, False),
                                             (4, 29, True)])
def test_ssm_forward_matches_reference(hybrid, chunk, s, carried):
    """Chunk 8 at S=20: two whole chunks and a partial one on both sides."""
    jcfg, cfg, jp, tp = hybrid
    x = _x((2, s, cfg.d_model), s)
    st = _ssm_state(cfg, 2, 5) if carried else None
    want, wstate = jssm.ssm_forward(jp, x, jcfg, state=st, chunk=chunk)
    got, gstate = ssm.ssm_forward(tp, _t(x), cfg, chunk=chunk,
                                  state=None if st is None else {n: _t(v) for n, v in st.items()})
    _close(got.numpy(), want)
    _close(gstate["h"].numpy(), wstate["h"])
    _close(gstate["conv"].numpy(), wstate["conv"])


def test_ssm_decode_matches_reference(hybrid):
    jcfg, cfg, jp, tp = hybrid
    st = _ssm_state(cfg, 3, 9)
    x = _x((3, 1, cfg.d_model), 10)
    want, wstate = jssm.ssm_decode(jp, x, jcfg, st)
    got, gstate = ssm.ssm_decode(tp, _t(x), cfg, {n: _t(v) for n, v in st.items()})
    _close(got.numpy(), want)
    _close(gstate["h"].numpy(), wstate["h"])
    _close(gstate["conv"].numpy(), wstate["conv"])


def test_ssm_init_matches_reference_layout():
    jcfg, cfg = _ssm_cfgs()
    want = jssm.init_ssm(jax.random.PRNGKey(0), jcfg)
    got = ssm.init_ssm(torch.Generator().manual_seed(0), cfg)
    stacked = ssm.init_ssm(torch.Generator().manual_seed(0), cfg, num_layers=2)
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == w.shape and stacked[name].shape == (2,) + w.shape
    for name in ("dt_bias", "log_a", "d_skip", "conv_b"):     # the deterministic leaves
        _close(got[name].numpy(), want[name], atol=1e-6)
        _close(stacked[name][1].numpy(), want[name], atol=1e-6)
