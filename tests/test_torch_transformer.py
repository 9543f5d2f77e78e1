"""Port vs reference, the dense transformer: ``models/layers``,
``models/attention`` (train / prefill / cached decode, the ring buffer),
``models/transformer`` (forward, the decode state) and the configs, on the
reduced qwen3-1.7b
(``qk_norm``, GQA) and qwen2.5-3b (``qkv_bias``, kv=2). Weights come from
the JAX package's ``init_params`` (norm and bias leaves perturbed so that
they matter) through ``convert.transformer_params_from_numpy``; inputs from
seeded numpy. Layers atol 1e-6, everything else 1e-4 (f32 on the CPU, the
two libraries' matmuls sum in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import make_attn_impl
from repro_torch.models import attention, layers, transformer

ATOL = 1e-4


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _perturbed(tree, seed):
    """The JAX init with every norm and bias leaf moved off its constant."""
    r = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for name, v in node.items():
            if isinstance(v, dict):
                out[name] = walk(v)
            else:
                v = np.asarray(v)
                if "norm" in name or name in ("bq", "bk", "bv"):
                    v = (v + 0.1 * r.normal(size=v.shape)).astype(np.float32)
                out[name] = v
        return out

    return walk(tree)


@pytest.fixture(scope="module", params=["qwen3-1.7b", "qwen2.5-3b"])
def model(request):
    cfg = jax_get_config(request.param).reduced()
    np_params = _perturbed(jtf.init_params(jax.random.PRNGKey(0), cfg), 1)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    t_params = convert.transformer_params_from_numpy(np_params)
    return cfg, get_config(request.param).reduced(), j_params, t_params


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.true_vocab_size, size=(b, s))


# ------------------------------------------------------------- layers ----

def test_layers_match_reference():
    r = np.random.default_rng(0)
    x = r.normal(size=(2, 7, 3, 16)).astype(np.float32)
    w = r.normal(size=(16,)).astype(np.float32)
    pos = r.integers(0, 40, size=(2, 7))
    np.testing.assert_allclose(layers.rms_norm(_t(x), _t(w), 1e-6).numpy(),
                               np.asarray(jlayers.rms_norm(x, w, 1e-6)), atol=1e-6)
    for theta in (1e4, 1e6):
        jc, js = jlayers.rotary_cos_sin(jnp.asarray(pos), 16, theta)
        tc, ts = layers.rotary_cos_sin(_t(pos), 16, theta)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
        np.testing.assert_allclose(layers.apply_rotary(_t(x), tc, ts).numpy(),
                                   np.asarray(jlayers.apply_rotary(x, jc, js)), atol=1e-6)
    h = r.normal(size=(2, 5, 16)).astype(np.float32)
    table = r.normal(size=(16, 12)).astype(np.float32)
    got = layers.unembed(_t(h), _t(table), true_vocab=9).numpy()
    want = np.asarray(jlayers.unembed(h, table, true_vocab=9))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (got[..., 9:] == np.finfo(np.float32).min).all()
    for q_len, kv_len, off, win in ((5, 5, 0, None), (6, 9, 3, None), (8, 8, 0, 3), (1, 12, 11, 4)):
        assert np.array_equal(layers.causal_mask(q_len, kv_len, off, win).numpy(),
                              np.asarray(jlayers.causal_mask(q_len, kv_len, off, win)))
    gates = [(0.2 * r.normal(size=s)).astype(np.float32) for s in ((16, 24), (16, 24), (24, 16))]
    np.testing.assert_allclose(layers.swiglu(_t(h), *map(_t, gates)).numpy(),
                               np.asarray(jlayers.swiglu(h, *gates)), atol=1e-6)


def test_norms_mlps_embedding_and_loss_match_reference():
    r = np.random.default_rng(1)
    x = r.normal(size=(3, 6, 16)).astype(np.float32)
    w, b = r.normal(size=(16,)).astype(np.float32), r.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(layers.layer_norm(_t(x), _t(w), _t(b)).numpy(),
                               np.asarray(jlayers.layer_norm(x, w, b)), atol=1e-6)
    mats = [(0.2 * r.normal(size=s)).astype(np.float32) for s in ((16, 24), (24,), (24, 16), (16,))]
    np.testing.assert_allclose(layers.gelu_mlp(_t(x), *map(_t, mats)).numpy(),
                               np.asarray(jlayers.gelu_mlp(x, *mats)), atol=1e-6)
    table = r.normal(size=(11, 16)).astype(np.float32)
    tok = r.integers(0, 11, size=(3, 6))
    assert np.array_equal(layers.embed(_t(tok), _t(table)).numpy(),
                          np.asarray(jlayers.embed(jnp.asarray(tok), table)))
    labels = r.integers(0, 16, size=(3, 6))
    labels[0, :2] = -1                                   # ignored positions
    np.testing.assert_allclose(float(layers.cross_entropy(_t(x), _t(labels))),
                               float(jlayers.cross_entropy(x, jnp.asarray(labels))), atol=1e-6)


# ---------------------------------------------------------- attention ----

def _layer0(params):
    return {n: v[0] for n, v in params["blocks"]["attn"].items()}


def test_attention_and_prefill_match_reference(model):
    jcfg, cfg, jp, tp = model
    r = np.random.default_rng(2)
    x = r.normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    jpa, tpa = jax.tree_util.tree_map(lambda v: v[0], jp["blocks"]["attn"]), _layer0(tp)
    for win in (None, 4):
        want = jattn.attention(jpa, jnp.asarray(x), jcfg, window=win)
        got = attention.attention(tpa, _t(x), cfg, window=win)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        wo, wk, wv = jattn.attention_prefill(jpa, jnp.asarray(x), jcfg, window=win)
        go, gk, gv = attention.attention_prefill(tpa, _t(x), cfg, window=win)
        for g, w in ((go, wo), (gk, wk), (gv, wv)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("t_max,length,win", [(10, 7, None), (10, 7, 4), (4, 6, 4), (4, 2, 4),
                                              (6, 9, None)])
def test_decode_attention_matches_reference(model, t_max, length, win):
    """Plain slots, a window inside a longer cache, the ring buffer (T_max <=
    window: slot = length mod T_max), and a full cache (slot T_max - 1)."""
    jcfg, cfg, jp, tp = model
    r = np.random.default_rng(t_max * 10 + length)
    b, kv, hd = 2, cfg.num_kv_heads, cfg.head_dim
    x = r.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    ck = r.normal(size=(b, t_max, kv, hd)).astype(np.float32)
    cv = r.normal(size=(b, t_max, kv, hd)).astype(np.float32)
    jpa = jax.tree_util.tree_map(lambda v: v[0], jp["blocks"]["attn"])
    want, wcache = jattn.decode_attention(
        jpa, jnp.asarray(x), jattn.KVCache(jnp.asarray(ck), jnp.asarray(cv),
                                           jnp.asarray(length, jnp.int32)), jcfg, window=win)
    cache = attention.KVCache(_t(ck).clone(), _t(cv).clone(), torch.tensor(length, dtype=torch.int32))
    got, gcache = attention.decode_attention(_layer0(tp), _t(x), cache, cfg, window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(gcache.k.numpy(), np.asarray(wcache.k), atol=ATOL)
    np.testing.assert_allclose(gcache.v.numpy(), np.asarray(wcache.v), atol=ATOL)
    assert int(gcache.length) == int(wcache.length) == length + 1
    assert gcache.k.data_ptr() == cache.k.data_ptr()        # written in place


def test_init_attn_zeroes_padded_head_rows():
    cfg = get_config("qwen3-1.7b").reduced().pad_for_mesh(3)
    assert cfg.true_num_heads < cfg.num_heads
    p = attention.init_attn(torch.Generator().manual_seed(0), cfg)
    hd = cfg.head_dim
    assert p["wo"].shape == (cfg.num_heads * hd, cfg.d_model)
    assert (p["wo"][cfg.true_num_heads * hd:] == 0).all()
    assert (p["wo"][:cfg.true_num_heads * hd] != 0).any()


# -------------------------------------------------------- transformer ----

def test_forward_matches_reference(model):
    jcfg, cfg, jp, tp = model
    tok = _tokens(cfg, 2, 13, 3)
    want = np.asarray(jtf.forward(jp, jnp.asarray(tok), jcfg))
    got = transformer.forward(tp, _t(tok), cfg)
    assert got.shape == (2, 13, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # the flash-attention adapter (CPU tensors: its plain version) is the default path
    via_impl = transformer.forward(tp, _t(tok), cfg, attn_impl=make_attn_impl())
    np.testing.assert_allclose(via_impl.numpy(), got.numpy(), atol=1e-5)
    np.testing.assert_allclose(via_impl.numpy(), want, atol=ATOL)


def test_init_decode_state_matches_reference(model):
    jcfg, cfg, _, _ = model
    want = jtf.init_decode_state(jcfg, 3, 9, cache_dtype=jnp.float32)
    got = transformer.init_decode_state(cfg, 3, 9, cache_dtype=torch.float32)
    assert got.kv.k.shape == want.kv.k.shape and got.kv.v.shape == want.kv.v.shape
    assert not got.kv.k.any() and got.kv.length.tolist() == [0] * cfg.num_layers
    assert got.rwkv is None and got.ssm is None and int(got.position) == 0
    assert convert.to_numpy(got).kv.k.shape == want.kv.k.shape


def test_params_round_trip_through_numpy(model):
    _, cfg, jp, tp = model
    back = convert.to_numpy(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat_j:
        node = back
        for key in path:
            node = node[key.key]
        assert node.shape == leaf.shape and node.dtype == np.float32
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert tp["blocks"]["attn"]["wq"].shape == (cfg.num_layers, cfg.d_model,
                                                cfg.num_heads * cfg.head_dim)


def test_dense_configs_resolve_like_the_reference():
    from repro.configs import ALL_CONFIGS as J_ALL
    from repro_torch.configs import ALL_CONFIGS
    assert sorted(ALL_CONFIGS) == sorted(J_ALL)
    for name, c in ALL_CONFIGS.items():
        j = J_ALL[name]
        assert c.param_count() == j.param_count()
        assert c.active_param_count() == j.active_param_count()
        assert c.reduced().__dict__ == j.reduced().__dict__
        assert c.pad_for_mesh(16).__dict__ == j.pad_for_mesh(16).__dict__
    assert get_config("qwen3-1.7b").param_count() == 2_031_732_736
