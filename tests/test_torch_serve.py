"""Port vs reference, the serving path: ``models/transformer.prefill`` (with
and without a rolled window cache) and ``decode_step``, the prefill-to-decode
handoff, and ``launch/serve.generate`` against the reference serve's greedy
loop, on the reduced qwen3-1.7b
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
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import make_attn_impl
from repro_torch.launch import serve
from repro_torch.models import transformer

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


# ------------------------------------------------------------ serving ----

@pytest.mark.parametrize("window", [None, 5])
def test_prefill_and_decode_match_reference(model, window):
    """prefill (with window 5 < S = 12 the cache is the last 5 positions,
    rolled into ring order), the cache padded as serve pads it, then decode
    steps fed the same tokens, against the JAX package."""
    jcfg, cfg, jp, tp = model
    b, s, gen = 2, 12, 3
    tok = _tokens(cfg, b, s + gen, 4)
    want_logits, jstate = jtf.prefill(jp, jnp.asarray(tok[:, :s]), jcfg, window=window,
                                      cache_dtype=jnp.float32)
    got_logits, state = transformer.prefill(tp, _t(tok[:, :s]), cfg, window=window,
                                            cache_dtype=torch.float32)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=ATOL)
    assert state.kv.k.shape == jstate.kv.k.shape == (
        cfg.num_layers, b, s if window is None else window, cfg.num_kv_heads, cfg.head_dim)
    np.testing.assert_allclose(state.kv.k.numpy(), np.asarray(jstate.kv.k), atol=ATOL)
    np.testing.assert_allclose(state.kv.v.numpy(), np.asarray(jstate.kv.v), atol=ATOL)
    assert state.kv.length.tolist() == np.asarray(jstate.kv.length).tolist()
    assert int(state.position) == int(jstate.position) == s

    # pad both caches to S + gen (the reference's serve.py does this in place of a helper)
    full = jtf.init_decode_state(jcfg, b, s + gen, cache_dtype=jnp.float32)
    pl = jstate.kv.k.shape[2]
    jfull = full._replace(kv=full.kv._replace(
        k=full.kv.k.at[:, :, :pl].set(jstate.kv.k), v=full.kv.v.at[:, :, :pl].set(jstate.kv.v),
        length=jnp.broadcast_to(jstate.kv.length, full.kv.length.shape)),
        position=jstate.position)
    tfull = serve.pad_cache(state, cfg, b, s + gen)
    assert tfull.kv.k.shape == jfull.kv.k.shape
    for i in range(gen):
        step = tok[:, s + i:s + i + 1]
        want_step, jfull = jtf.decode_step(jp, jnp.asarray(step), jfull, jcfg)
        got_step, tfull = transformer.decode_step(tp, _t(step), tfull, cfg)
        np.testing.assert_allclose(got_step.numpy(), np.asarray(want_step), atol=ATOL)
    np.testing.assert_allclose(tfull.kv.k.numpy(), np.asarray(jfull.kv.k), atol=ATOL)
    assert tfull.kv.length.tolist() == [s + gen] * cfg.num_layers
    assert int(tfull.position) == s + gen


def test_prefill_handoff_to_decode_matches_forward():
    """tests/test_arch_smoke.py's handoff, on the port, held to the JAX
    forward: prefill(s tokens) then one decode step equals the forward's
    logits at positions s - 1 and s (atol 2e-3, the reference's)."""
    jcfg = jax_get_config("qwen3-1.7b").reduced()
    cfg = get_config("qwen3-1.7b").reduced()
    np_params = jax.tree_util.tree_map(np.asarray, jtf.init_params(jax.random.PRNGKey(0), jcfg))
    tp = convert.transformer_params_from_numpy(np_params)
    b, s = 1, 10
    tok = _tokens(cfg, b, s + 1, 5)
    full = np.asarray(jtf.forward(jax.tree_util.tree_map(jnp.asarray, np_params),
                                  jnp.asarray(tok), jcfg))
    last, state = transformer.prefill(tp, _t(tok[:, :s]), cfg, cache_dtype=torch.float32)
    np.testing.assert_allclose(last.numpy(), full[:, s - 1], atol=2e-3)
    lg, _ = transformer.decode_step(tp, _t(tok[:, s:s + 1]), serve.pad_cache(state, cfg, b, s + 1),
                                    cfg)
    np.testing.assert_allclose(lg.numpy(), full[:, s], atol=2e-3)


def test_serve_greedy_tokens_match_the_reference_loop(model):
    """serve.generate (prefill through make_attn_impl, padded cache, greedy
    decode) against the reference serve's loop on the same weights and
    prompts: the same tokens, the last logits to 1e-4."""
    jcfg, cfg, jp, tp = model
    b, s, gen = 2, 9, 6
    tok = _tokens(cfg, b, s, 6)
    logits, jstate = jtf.prefill(jp, jnp.asarray(tok), jcfg, cache_dtype=jnp.float32)
    full = jtf.init_decode_state(jcfg, b, s + gen, cache_dtype=jnp.float32)
    full = full._replace(kv=full.kv._replace(
        k=full.kv.k.at[:, :, :s].set(jstate.kv.k), v=full.kv.v.at[:, :, :s].set(jstate.kv.v),
        length=jnp.broadcast_to(jstate.kv.length, full.kv.length.shape)),
        position=jstate.position)
    want_tokens = []
    cur = jnp.argmax(logits, axis=-1)[:, None]
    for _ in range(gen):
        want_tokens.append(cur)
        logits, full = jtf.decode_step(jp, cur, full, jcfg)
        cur = jnp.argmax(logits, axis=-1)[:, None]
    res = serve.generate(tp, _t(tok), cfg, gen=gen, attn_impl=make_attn_impl())
    assert res.tokens.tolist() == np.asarray(jnp.concatenate(want_tokens, axis=1)).tolist()
    np.testing.assert_allclose(res.last_logits.numpy(), np.asarray(logits), atol=ATOL)
    assert res.cache_len == s + gen and res.prefill_s >= 0 and res.decode_s >= 0


def test_serve_main_on_the_cpu(capsys):
    res = serve.main(["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu", "--batch", "1",
                      "--prompt-len", "8", "--gen", "3", "--window", "4"])
    assert res.tokens.shape == (1, 3) and res.cache_len == 11
    assert torch.isfinite(res.last_logits).all()
    assert "decode 3 steps" in capsys.readouterr().out
