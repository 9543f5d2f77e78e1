"""Port vs reference, the model zoo beyond the dense family: the frontend
stub (``models/multimodal``), the blocked attention twin
(``models/attention.blocked_sdpa``) and, for each of granite-moe-1b-a400m,
mixtral-8x7b, rwkv6-3b, hymba-1.5b, internvl2-26b and musicgen-large at
their reduced sizes, ``models/transformer`` (the parameter tree, forward
with the frontend prefix, prefill with its decode state, decode steps after
the padded handoff) and ``launch/serve`` (``generate``'s greedy tokens
against the reference serve's loop, the CLI). mixtral prefills 70 tokens
past its reduced window of 64, so its cache rolls into ring order and decode
wraps around it.

Weights come from the JAX package's ``init_params`` with every constant leaf
moved off its constant, through ``convert.transformer_params_from_numpy``;
inputs and frontend features from seeded numpy. One module-scoped fixture
per architecture runs the reference once (forward, prefill and decode, each
jitted once). Whole models atol 1e-4, modules 1e-5 (f32 on the CPU).
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import multimodal as jmm
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import make_attn_impl
from repro_torch.launch import serve
from repro_torch.models import attention, layers, multimodal, transformer

ATOL = 1e-4
ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["granite-moe-1b-a400m", "mixtral-8x7b", "rwkv6-3b", "hymba-1.5b", "internvl2-26b",
         "musicgen-large"]
CONSTANT_LEAVES = ("mix_mu", "mix_k", "mix_r", "decay_w0", "ln_x", "conv_b", "dt_bias",
                   "log_a", "d_skip", "bq", "bk", "bv")
B, GEN = 2, 3


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _perturbed(tree, seed):
    """The JAX init with every norm, bias and other constant leaf moved off
    its constant."""
    r = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for name, v in node.items():
            if isinstance(v, dict):
                out[name] = walk(v)
                continue
            v = np.asarray(v)
            if "norm" in name or name in CONSTANT_LEAVES:
                v = (v + 0.1 * r.normal(size=v.shape)).astype(np.float32)
            out[name] = v
        return out

    return walk(tree)


def _reference_w(cfg):
    """The reference stub's projection, rebuilt as ``multimodal.py`` draws it
    (seeded by this process's ``hash`` of the name)."""
    f = jmm.frontend_feature_dim(cfg)
    seed = abs(hash(cfg.name)) % (2 ** 31)
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (f, cfg.d_model), jnp.float32))


def _pad_reference(jcfg, st, total):
    """The reference serve's padding of a prefill state (``serve.py:55-66``)."""
    full = jtf.init_decode_state(jcfg, B, total, cache_dtype=jnp.float32)
    if st.kv is not None:
        pl = st.kv.k.shape[2]
        full = full._replace(kv=full.kv._replace(
            k=full.kv.k.at[:, :, :pl].set(st.kv.k), v=full.kv.v.at[:, :, :pl].set(st.kv.v),
            length=jnp.broadcast_to(st.kv.length, full.kv.length.shape)))
    return full._replace(rwkv=st.rwkv, ssm=st.ssm, position=st.position)


@pytest.fixture(scope="module", params=ARCHS)
def zoo(request):
    arch = request.param
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    np_params = _perturbed(jtf.init_params(jax.random.PRNGKey(0), jcfg), 1)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    s = 70 if cfg.sliding_window else 12
    r = np.random.default_rng(len(arch))
    tok = r.integers(0, cfg.true_vocab_size, size=(B, s + GEN))
    prefix = None
    if cfg.embed_input:
        raw = r.normal(size=(B, cfg.frontend_tokens, jmm.frontend_feature_dim(jcfg)))
        prefix = np.asarray(jmm.frontend_embeddings(jcfg, jnp.asarray(raw, jnp.float32)))
    fwd = jax.jit(lambda p, t, pre: jtf.forward(p, t, jcfg, prefix_embeds=pre))
    pre = jax.jit(lambda p, t, pf: jtf.prefill(p, t, jcfg, prefix_embeds=pf,
                                               cache_dtype=jnp.float32))
    dec = jax.jit(lambda p, t, st: jtf.decode_step(p, t, st, jcfg))

    want = {"forward": np.asarray(fwd(jp, tok, prefix))}
    logits, st = pre(jp, tok[:, :s], prefix)
    want["prefill"] = (np.asarray(logits), jax.tree_util.tree_map(np.asarray, st))
    total = int(st.position) + GEN
    full, steps = _pad_reference(jcfg, st, total), []
    for i in range(GEN):                      # decode fed the prompt's next tokens
        lg, full = dec(jp, tok[:, s + i:s + i + 1], full)
        steps.append(np.asarray(lg))
    want["steps"], want["final"] = steps, jax.tree_util.tree_map(np.asarray, full)
    full, greedy = _pad_reference(jcfg, st, total), []
    cur = jnp.argmax(logits, axis=-1)[:, None]
    for _ in range(GEN):                      # the reference serve's greedy loop
        greedy.append(np.asarray(cur))
        lg, full = dec(jp, cur, full)
        cur = jnp.argmax(lg, axis=-1)[:, None]
    want["greedy"], want["greedy_logits"] = np.concatenate(greedy, 1), np.asarray(lg)
    tp = convert.transformer_params_from_numpy(np_params)
    return jcfg, cfg, tp, s, tok, prefix, want


def _prefix(prefix):
    return None if prefix is None else _t(prefix)


def _impl(cfg):
    return make_attn_impl(window=cfg.sliding_window)


# ------------------------------------------------------------ frontend ----

@pytest.mark.parametrize("arch", ["internvl2-26b", "musicgen-large"])
def test_frontend_embeddings_match_reference(arch):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    f = multimodal.frontend_feature_dim(cfg)
    assert f == jmm.frontend_feature_dim(jcfg)
    raw = np.random.default_rng(0).normal(size=(2, cfg.frontend_tokens, f)).astype(np.float32)
    want = np.asarray(jmm.frontend_embeddings(jcfg, jnp.asarray(raw)))
    got = multimodal.frontend_embeddings(cfg, _t(raw), w=_t(_reference_w(jcfg)))
    assert got.shape == (2, cfg.frontend_tokens, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the default projection: seeded by the name's digest, the same in every call
    a = multimodal.frontend_embeddings(cfg, _t(raw))
    assert torch.equal(a, multimodal.frontend_embeddings(cfg, _t(raw)))
    assert torch.equal(multimodal.frontend_projection(cfg),
                       multimodal.frontend_projection(cfg, "cpu"))
    with pytest.raises(ValueError, match="frontend positions"):
        multimodal.frontend_embeddings(cfg, _t(raw[:, 1:]))


def test_frontend_projection_is_the_same_in_every_process():
    code = ("import sys; sys.path.insert(0, 'src'); from repro_torch.configs import get_config;"
            "from repro_torch.models import multimodal;"
            "print(float(multimodal.frontend_projection(get_config('musicgen-large'))"
            ".double().sum()))")
    runs = {subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           cwd=ROOT, env={"PATH": "", "PYTHONHASHSEED": seed}).stdout
            for seed in ("1", "2")}
    want = float(multimodal.frontend_projection(get_config("musicgen-large")).double().sum())
    assert runs == {f"{want}\n"}
    with pytest.raises(ValueError, match="no frontend"):
        multimodal.frontend_feature_dim(get_config("qwen3-1.7b"))


# -------------------------------------------------------- blocked sdpa ----

@pytest.mark.parametrize("s,h,kv,window", [(20, 4, 2, None), (20, 4, 4, 5), (17, 6, 2, 8),
                                           (8, 2, 1, None)])
def test_blocked_sdpa_matches_reference(s, h, kv, window):
    """Block 8: whole and partial q and kv blocks, blocks with no kept key
    (above the diagonal; outside the window)."""
    r = np.random.default_rng(s + h)
    q = r.normal(size=(2, s, h, 16)).astype(np.float32)
    k, v = (r.normal(size=(2, s, kv, 16)).astype(np.float32) for _ in range(2))
    want = jattn.blocked_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, 0.3,
                              block=8, window=window)
    got = attention.blocked_sdpa(_t(q), _t(k), _t(v), None, 0.3, block=8, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    mask = layers.causal_mask(s, s, 0, window)
    np.testing.assert_allclose(got.numpy(), attention._sdpa(_t(q), _t(k), _t(v), mask, 0.3)
                               .numpy(), atol=1e-5)
    impl = attention.make_blocked_impl(window=window, block=8)
    assert torch.equal(impl(_t(q), _t(k), _t(v), None, 0.3), got)


# ---------------------------------------------------- the six families ----

def test_init_params_tree_matches_reference(zoo):
    """The port's own init draws the reference's tree: names, shapes, dtype;
    the decode state too."""
    jcfg, cfg, tp, *_ = zoo
    got = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    want = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    paths = {jax.tree_util.keystr(p): v.shape for p, v in
             jax.tree_util.tree_leaves_with_path(want)}
    got_paths = {jax.tree_util.keystr(p): v.shape for p, v in
                 jax.tree_util.tree_leaves_with_path(convert.to_numpy(got))}
    assert got_paths == paths
    assert all(t.dtype == torch.float32 for t in jax.tree_util.tree_leaves(got))
    jstate = jtf.init_decode_state(jcfg, 2, 9, cache_dtype=jnp.float32)
    state = transformer.init_decode_state(cfg, 2, 9, cache_dtype=torch.float32)
    for name in ("kv", "rwkv", "ssm"):
        j, t = getattr(jstate, name), getattr(state, name)
        assert (j is None) == (t is None), name
        if j is not None:
            assert jax.tree_util.tree_map(np.shape, j) == \
                jax.tree_util.tree_map(np.shape, convert.to_numpy(t)), name


def test_forward_matches_reference(zoo):
    jcfg, cfg, tp, s, tok, prefix, want = zoo
    p = 0 if prefix is None else prefix.shape[1]
    got = transformer.forward(tp, _t(tok), cfg, prefix_embeds=_prefix(prefix))
    assert got.shape == (B, p + s + GEN, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want["forward"], atol=ATOL)
    # through the flash adapter (CPU tensors: its plain version) with the config's window
    via_impl = transformer.forward(tp, _t(tok), cfg, prefix_embeds=_prefix(prefix),
                                   attn_impl=_impl(cfg))
    np.testing.assert_allclose(via_impl.numpy(), want["forward"], atol=ATOL)


def _assert_state(state, jstate):
    for name in ("kv", "rwkv", "ssm"):
        j, t = getattr(jstate, name), getattr(state, name)
        assert (j is None) == (t is None), name
        if j is None:
            continue
        for a, b in zip(jax.tree_util.tree_leaves(convert.to_numpy(t)),
                        jax.tree_util.tree_leaves(j)):
            assert a.shape == b.shape, name
            np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)
    assert int(state.position) == int(jstate.position)


def test_prefill_and_decode_match_reference(zoo):
    """prefill (the prefix, then S tokens), the state padded as the serve pads
    it, then GEN decode steps fed the prompt's next tokens; the steps also
    continue the reference's forward at positions P + S + i."""
    jcfg, cfg, tp, s, tok, prefix, want = zoo
    p = 0 if prefix is None else prefix.shape[1]
    logits, state = transformer.prefill(tp, _t(tok[:, :s]), cfg, prefix_embeds=_prefix(prefix),
                                        attn_impl=_impl(cfg), cache_dtype=torch.float32)
    want_logits, jstate = want["prefill"]
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=ATOL)
    _assert_state(state, jstate)
    assert int(state.position) == p + s
    if cfg.sliding_window:
        assert s > cfg.sliding_window and state.kv.k.shape[2] == cfg.sliding_window
    full = serve.pad_cache(state, cfg, B, p + s + GEN)
    for i in range(GEN):
        step, full = transformer.decode_step(tp, _t(tok[:, s + i:s + i + 1]), full, cfg)
        np.testing.assert_allclose(step.numpy(), want["steps"][i], atol=ATOL)
        np.testing.assert_allclose(step.numpy(), want["forward"][:, p + s + i], atol=ATOL)
    _assert_state(full, want["final"])


def test_generate_matches_the_reference_serve_loop(zoo):
    jcfg, cfg, tp, s, tok, prefix, want = zoo
    p = 0 if prefix is None else prefix.shape[1]
    res = serve.generate(tp, _t(tok[:, :s]), cfg, gen=GEN, attn_impl=_impl(cfg),
                         prefix_embeds=_prefix(prefix))
    assert res.tokens.tolist() == want["greedy"].tolist()
    np.testing.assert_allclose(res.prefill_logits.numpy(), want["prefill"][0], atol=ATOL)
    np.testing.assert_allclose(res.last_logits.numpy(), want["greedy_logits"], atol=ATOL)
    assert res.cache_len == p + s + GEN


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_the_cpu(arch, capsys):
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "1",
                      "--prompt-len", "8", "--gen", "3"])
    cfg = get_config(arch).reduced()
    assert res.tokens.shape == (1, 3) and torch.isfinite(res.last_logits).all()
    assert res.cache_len == cfg.frontend_tokens + 8 + 3
    assert "decode 3 steps" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b"])
def test_torch_serve_batched_example_smoke(arch):
    run = subprocess.run([sys.executable, "examples/torch_serve_batched.py", "--smoke",
                          "--device", "cpu", "--arch", arch], capture_output=True, text=True,
                         cwd=ROOT, env={"PATH": "", "PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert run.returncode == 0, run.stderr
    assert f"serve_batched OK: {arch}-reduced" in run.stdout
