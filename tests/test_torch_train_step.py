"""Port vs reference, the training slice: ``models/transformer.forward_with_aux``
/ ``lm_loss`` and their gradients, ``remat``, ``core/aggregation.mix_params_lowp``,
``launch/variants.apply_variant``, one round of ``launch/steps.build_dds_train_step``
and the train CLI's transformer branch.

Weights come from the JAX package's ``init_params`` with every norm and
constant leaf moved off its constant, through ``convert``; tokens, frontend
prefixes and the starting federation state (each vehicle's parameters apart,
AdamW moments at a count of 3, state vectors on the simplex) from seeded
numpy. The round runs the reduced qwen3-1.7b (dense), granite-moe-1b-a400m
(the MoE aux loss) and musicgen-large (a frontend prefix) at V = 4 vehicles on
a ring, one module-scoped fixture per architecture that jits the reference's
step once. Tolerances, f32 on the CPU: the loss, aux loss and gradients 1e-5 of
their scale for a module, 1e-4 for a whole model; ``mix_params_lowp`` 1e-6;
a round's loss, kl and state matrix 1e-5, its parameters and moments 1e-4
(AdamW divides by the root of the second moment, which takes a gradient's
rounding with it); the bf16 compute variant's loss 5e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import checkpoint as ref_ckpt
from repro.configs import get_config as jax_get_config
from repro.core import aggregation as jagg
from repro.launch import steps as jsteps
from repro.launch import variants as jvariants
from repro.models import transformer as jtf
from repro.optim import AdamState as JAdamState
from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHITECTURES, PORT_ONLY
from repro_torch.core import aggregation
from repro_torch.kernels.adamw import kernel as adamw_kernel
from repro_torch.launch import steps, train, variants
from repro_torch.models import attention, transformer
from repro_torch.optim import AdamState, apply_updates

LOSS_ARCHS = ["qwen3-1.7b", "granite-moe-1b-a400m", "rwkv6-3b", "hymba-1.5b", "internvl2-26b"]
ROUND_ARCHS = ["qwen3-1.7b", "granite-moe-1b-a400m", "musicgen-large"]
CONSTANT_LEAVES = ("mix_mu", "mix_k", "mix_r", "decay_w0", "ln_x", "conv_b", "dt_bias",
                   "log_a", "d_skip", "bq", "bk", "bv")
V, B, S = 4, 2, 16
LR, P1_STEPS = 1e-3, 40


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: these small products run no faster on more, and
    the suite's parallel workers would otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _flat(tree):
    return steps.flatten(tree)


def _prefix(cfg, r, *lead):
    if not cfg.embed_input:
        return None
    return (0.02 * r.normal(size=lead + (cfg.frontend_tokens, cfg.d_model))).astype(np.float32)


def _t(x):
    return None if x is None else torch.as_tensor(np.asarray(x))


def _scale_err(got, want) -> float:
    """max |got - want| over the larger of 1 and max |want|."""
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(1.0, np.abs(want).max()))


# ------------------------------------------------------- lm_loss, gradients ---

@pytest.fixture(scope="module", params=LOSS_ARCHS)
def loss_case(request):
    arch = request.param
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    np_params = _perturbed(jtf.init_params(jax.random.PRNGKey(0), jcfg), 1)
    r = np.random.default_rng(len(arch))
    tok = r.integers(0, cfg.true_vocab_size, size=(B, S)).astype(np.int32)
    prefix = _prefix(cfg, r, B)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    fwd = jax.jit(lambda p, t, pre: jtf.forward_with_aux(p, t, jcfg, prefix_embeds=pre))
    vg = jax.jit(jax.value_and_grad(
        lambda p, t, pre: jtf.lm_loss(p, t, jcfg, prefix_embeds=pre)))
    logits, aux = fwd(jp, tok, prefix)
    loss, grads = vg(jp, tok, prefix)
    grads = _flat(jax.tree_util.tree_map(np.asarray, grads))
    # the reference's own rounding noise: its gradients under the parameters
    # scaled by 1 + 1e-6 z (z standard normal: about 8 f32 ulps)
    z = np.random.default_rng(0)
    nudged = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x * (1 + 1e-6 * z.normal(size=x.shape)).astype(np.float32)),
        np_params)
    _, moved = vg(nudged, tok, prefix)
    noise = {k: float(np.abs(g - grads[k]).max())
             for k, g in _flat(jax.tree_util.tree_map(np.asarray, moved)).items()}
    want = {"logits": np.asarray(logits), "aux": float(aux), "loss": float(loss),
            "grads": grads, "noise": noise}
    return cfg, np_params, tok, prefix, want


def _port_loss_and_grads(cfg, np_params, tok, prefix, **kw):
    leaves = {k: v.requires_grad_() for k, v in
              _flat(convert.transformer_params_from_numpy(np_params)).items()}
    loss = transformer.lm_loss(steps.unflatten(leaves), _t(tok), cfg,
                               prefix_embeds=_t(prefix), **kw)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: g.numpy() for k, g in zip(leaves, grads)}


def test_forward_with_aux_matches_reference(loss_case):
    cfg, np_params, tok, prefix, want = loss_case
    params = convert.transformer_params_from_numpy(np_params)
    with torch.no_grad():
        logits, aux = transformer.forward_with_aux(params, _t(tok), cfg, prefix_embeds=_t(prefix))
        plain = transformer.forward(params, _t(tok), cfg, prefix_embeds=_t(prefix))
    assert logits.shape == want["logits"].shape and aux.dtype == torch.float32
    assert _scale_err(logits.numpy(), want["logits"]) <= 1e-4
    assert abs(float(aux) - want["aux"]) <= 1e-5 * max(1.0, abs(want["aux"]))
    assert (float(aux) > 0) == cfg.is_moe            # 0 for every family but the MoE
    assert torch.equal(plain, logits)                # forward drops the aux loss


def test_lm_loss_and_its_gradients_match_reference(loss_case):
    cfg, np_params, tok, prefix, want = loss_case
    loss, grads = _port_loss_and_grads(cfg, np_params, tok, prefix)
    assert abs(loss - want["loss"]) <= 1e-5 * max(1.0, abs(want["loss"]))
    assert sorted(grads) == sorted(want["grads"])
    # each leaf within 1e-4 of its scale, or within the reference's own
    # rounding noise where that is larger (rwkv6's embedding gradient: a
    # layer norm over embeddings of std 0.02 amplifies rounding 50-fold)
    bound = {k: max(1e-4, want["noise"][k] / max(1.0, np.abs(g).max()))
             for k, g in want["grads"].items()}
    errs = {k: _scale_err(grads[k], want["grads"][k]) for k in grads}
    worst = max(errs, key=lambda k: errs[k] / bound[k])
    largest = max(errs, key=errs.get)
    print(f"{cfg.name}: loss {loss:.6f}; gradients within {errs[largest]:.2e} of their "
          f"scale ({largest}, bound {bound[largest]:.2e}); nearest its bound: {worst} "
          f"{errs[worst]:.2e} of {bound[worst]:.2e}")
    assert errs[worst] <= bound[worst], errs


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m", "hymba-1.5b"])
def test_remat_gives_the_gradients_of_no_remat(arch):
    cfg = get_config(arch).reduced()
    np_params = convert.to_numpy(transformer.init_params(torch.Generator().manual_seed(0), cfg))
    tok = np.random.default_rng(3).integers(0, cfg.true_vocab_size, size=(B, S))
    a_loss, a = _port_loss_and_grads(cfg, np_params, tok, None, remat=True)
    b_loss, b = _port_loss_and_grads(cfg, np_params, tok, None, remat=False)
    assert a_loss == b_loss
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6)


# -------------------------------------------------------- mix_params_lowp ---

@pytest.mark.parametrize("k_out,k_in", [(4, 4), (3, 5)])
def test_mix_params_lowp_matches_reference(k_out, k_in):
    r = np.random.default_rng(k_out * 10 + k_in)
    w = r.dirichlet(np.ones(k_in), size=k_out).astype(np.float32)
    tree = {"a": r.normal(size=(k_in, 33, 7)).astype(np.float32),
            "b": r.normal(size=(k_in, 300)).astype(np.float32)}
    want = jagg.mix_params_lowp(jnp.asarray(w), {k: jnp.asarray(v) for k, v in tree.items()})
    got = aggregation.mix_params_lowp(torch.as_tensor(w), {k: _t(v) for k, v in tree.items()})
    for k in tree:
        assert got[k].shape == want[k].shape and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6)
    exact = aggregation.mix_params(torch.as_tensor(w), {k: _t(v) for k, v in tree.items()})
    assert 0 < _scale_err(got["b"].numpy(), exact["b"].numpy()) <= 2e-2


# ---------------------------------------------------------------- variants ---

@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m", "rwkv6-3b",
                                  "mixtral-8x7b"])
@pytest.mark.parametrize("shape_kind", ["train", "prefill", "decode"])
def test_apply_variant_matches_reference(arch, shape_kind):
    assert variants.VARIANTS == jvariants.VARIANTS
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in variants.VARIANTS:
        try:
            want_cfg, want = jvariants.apply_variant(name, jcfg, shape_kind)
        except ValueError as err:
            with pytest.raises(ValueError, match=str(err).replace("(", r"\(")):
                variants.apply_variant(name, cfg, shape_kind)
            continue
        got_cfg, got = variants.apply_variant(name, cfg, shape_kind)
        assert got_cfg.moe_impl == want_cfg.moe_impl and got_cfg.name == want_cfg.name
        assert sorted(got) == sorted(want), name
        if "compute_dtype" in got:
            assert got["compute_dtype"] is torch.bfloat16 and want["compute_dtype"] is jnp.bfloat16
        if "mix_params_fn" in got:
            assert got["mix_params_fn"] is aggregation.mix_params_lowp
        if "attn_impl" in got:       # the blocked plain attention, at the config's window
            q = torch.randn(1, 80, 2, 16, generator=torch.Generator().manual_seed(0))
            mask = torch.ones(80, 80, dtype=torch.bool).tril()
            if cfg.sliding_window:
                mask &= ~torch.ones(80, 80, dtype=torch.bool).tril(-cfg.sliding_window)
            torch.testing.assert_close(got["attn_impl"](q, q, q, None, 0.25),
                                       attention._sdpa(q, q, q, mask, 0.25),
                                       rtol=0, atol=1e-5)


def test_apply_variant_errors():
    cfg = get_config("qwen3-1.7b")
    with pytest.raises(ValueError, match="'ragged_moe' not applicable"):
        variants.apply_variant("ragged_moe", cfg, "train")
    with pytest.raises(ValueError, match="'nope' not applicable"):
        variants.apply_variant("nope", cfg, "train")
    with pytest.raises(ValueError, match="'flash' not applicable"):
        variants.apply_variant("flash", get_config("rwkv6-3b"), "prefill")
    with pytest.raises(KeyError):
        variants.apply_variant("opt", cfg, "serve")
    assert variants.apply_variant("baseline", cfg, "serve") == (cfg, {})


# ------------------------------------------------------------- one round ---

def _ring(v):
    return np.minimum(np.eye(v) + np.roll(np.eye(v), 1, 1) + np.roll(np.eye(v), -1, 1),
                      1).astype(np.float32)


def _start_state(jcfg, seed):
    """Four vehicles of one perturbed init, each moved apart; AdamW moments
    after three steps; state vectors on the simplex."""
    r = np.random.default_rng(seed)
    one = _perturbed(jtf.init_params(jax.random.PRNGKey(0), jcfg), seed)
    params = jax.tree_util.tree_map(
        lambda x: (x[None] + 0.02 * r.normal(size=(V,) + x.shape)).astype(np.float32), one)
    mu = jax.tree_util.tree_map(lambda x: (1e-3 * r.normal(size=x.shape)).astype(np.float32),
                                params)
    nu = jax.tree_util.tree_map(      # above the first moment's square, as in training
        lambda m: (2 * m * m + 1e-6 * np.abs(r.normal(size=m.shape))).astype(np.float32), mu)
    opt = JAdamState(count=np.full((V,), 3, np.int32), mu=mu, nu=nu)
    sm = r.dirichlet(np.ones(V), size=V).astype(np.float32)
    return params, opt, sm


@pytest.fixture(scope="module", params=ROUND_ARCHS)
def round_case(request):
    arch = request.param
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    params, opt, sm = _start_state(jcfg, len(arch))
    r = np.random.default_rng(7)
    tok = r.integers(0, cfg.true_vocab_size, size=(V, B, S)).astype(np.int32)
    prefix = _prefix(cfg, r, V, B)
    contact, target = _ring(V), np.full((V,), 1.0 / V, np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1), ("vehicle", "fsdp", "model"))
    ts = jsteps.build_dds_train_step(jcfg, mesh, lr=LR, remat=False, p1_steps=P1_STEPS)
    extra = () if prefix is None else (jnp.asarray(prefix),)
    out = jax.jit(ts.fn)(*jax.tree_util.tree_map(jnp.asarray, (params, opt, sm, tok, contact,
                                                              target)),
                         jax.random.PRNGKey(2), *extra)
    want = jax.tree_util.tree_map(np.asarray, out)
    inputs = dict(params=params, opt=opt, sm=sm, tok=tok, prefix=prefix, contact=contact,
                  target=target)
    return cfg, inputs, want, _port_round(cfg, inputs)


def _port_round(cfg, inputs, **kw):
    params, opt, sm = convert.train_state_from_numpy(inputs["params"], inputs["opt"],
                                                     inputs["sm"])
    ts = steps.build_dds_train_step(cfg, lr=LR, remat=False, p1_steps=P1_STEPS, **kw)
    return ts.fn(params, opt, sm, _t(inputs["tok"]), _t(inputs["contact"]),
                 _t(inputs["target"]), _t(inputs["prefix"]))


def test_one_round_matches_reference(round_case):
    cfg, inputs, (w_params, w_opt, w_sm, w_metrics), (params, opt, sm, metrics) = round_case
    for name in ("loss", "kl"):
        assert abs(float(metrics[name]) - float(w_metrics[name])) <= 1e-5, name
    np.testing.assert_allclose(sm.numpy(), w_sm, rtol=0, atol=1e-5)
    np.testing.assert_allclose(sm.numpy().sum(1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(opt.count.numpy(), w_opt.count)
    worst = {}
    for what, got, want in (("params", params, w_params), ("mu", opt.mu, w_opt.mu),
                            ("nu", opt.nu, w_opt.nu)):
        got, want = _flat(got), _flat(want)
        assert sorted(got) == sorted(want)
        errs = {k: float(np.abs(got[k].numpy() - want[k]).max()) for k in got}
        worst[what] = max(errs.values())
    print(f"{cfg.name}: loss {float(metrics['loss']):.6f} kl {float(metrics['kl']):.6f}; "
          f"largest difference after the round {worst}")
    assert max(worst.values()) <= 1e-4, worst
    moved = max(float(np.abs(_flat(params)[k].numpy() - inputs_leaf).max())
                for k, inputs_leaf in _flat(inputs["params"]).items())
    assert moved > LR / 2                            # the parameters moved


def test_round_with_the_reference_mix_and_bf16_compute(round_case):
    """``mix_params_fn=aggregation.mix_params`` (the reference's default,
    functional and copied back) gives the round of the default in-place CPU
    mix exactly (the same product on the same leaves); the bf16 compute
    variant keeps the loss within 5e-2 and leaves the master weights f32."""
    cfg, inputs, (w_params, _, _, w_metrics), a = round_case
    b = _port_round(cfg, inputs, mix_params_fn=aggregation.mix_params)
    assert float(a[3]["loss"]) == float(b[3]["loss"])
    assert float(a[3]["kl"]) == float(b[3]["kl"])
    assert torch.equal(a[2], b[2])
    for what in ("params", "mu", "nu"):
        got = _flat(a[0] if what == "params" else getattr(a[1], what))
        want = _flat(b[0] if what == "params" else getattr(b[1], what))
        for k, leaf in got.items():
            assert torch.equal(want[k], leaf), (what, k)
    _, overrides = variants.apply_variant("bf16", cfg, "train")
    params, _, _, metrics = _port_round(cfg, inputs, **overrides)
    assert all(x.dtype == torch.float32 for x in _flat(params).values())
    assert abs(float(metrics["loss"]) - float(w_metrics["loss"])) <= 5e-2


def test_round_with_the_default_mix_keeps_every_leaf_in_place(round_case, monkeypatch):
    """Without a ``mix_params_fn`` the round mixes through
    ``ops.mix_params_cuda_``, once, on the flattened leaves of ``params``
    themselves; after the round every parameter and moment leaf is the tensor
    it was, at the same ``data_ptr()``, and the returned trees hold them."""
    cfg, inputs, _, _ = round_case
    calls = []
    real = steps.mix_params_cuda_

    def spy(mixing, flat):
        calls.append(dict(flat))
        return real(mixing, flat)

    monkeypatch.setattr(steps, "mix_params_cuda_", spy)
    params, opt, sm = convert.train_state_from_numpy(inputs["params"], inputs["opt"],
                                                     inputs["sm"])
    before = {what: {k: (x, x.data_ptr()) for k, x in _flat(tree).items()}
              for what, tree in (("params", params), ("mu", opt.mu), ("nu", opt.nu))}
    ts = steps.build_dds_train_step(cfg, lr=LR, remat=False, p1_steps=P1_STEPS)
    out, out_opt, _, _ = ts.fn(params, opt, sm, _t(inputs["tok"]), _t(inputs["contact"]),
                               _t(inputs["target"]), _t(inputs["prefix"]))
    assert len(calls) == 1
    assert all(calls[0][k] is x for k, (x, _) in before["params"].items())
    for what, tree in (("params", out), ("mu", out_opt.mu), ("nu", out_opt.nu)):
        after = _flat(tree)
        assert sorted(after) == sorted(before[what])
        for k, (x, ptr) in before[what].items():
            assert after[k] is x and after[k].data_ptr() == ptr, (what, k)


def test_round_past_the_in_place_limit_copies_the_functional_mix_back(round_case,
                                                                      monkeypatch):
    """Where the kernel does not mix V x V in place (on the card, V past the
    column mapping's limit; forced here), the default round takes the
    functional ``mix_params_cuda`` once and copies it back: the same round,
    exactly, with every parameter leaf at its ``data_ptr()``. On the CPU the
    round asks no kernel library whether it mixes in place."""
    cfg, inputs, _, a = round_case
    assert steps._mixes_in_place(_t(inputs["sm"]))
    calls = {"functional": 0, "in_place": 0}
    functional, in_place = steps.mix_params_cuda, steps.mix_params_cuda_

    def count(what, fn):
        def wrapped(mixing, flat):
            calls[what] += 1
            return fn(mixing, flat)
        return wrapped

    monkeypatch.setattr(steps, "_mixes_in_place", lambda mixing: False)
    monkeypatch.setattr(steps, "mix_params_cuda", count("functional", functional))
    monkeypatch.setattr(steps, "mix_params_cuda_", count("in_place", in_place))
    params, opt, sm = convert.train_state_from_numpy(inputs["params"], inputs["opt"],
                                                     inputs["sm"])
    ptrs = {k: x.data_ptr() for k, x in _flat(params).items()}
    ts = steps.build_dds_train_step(cfg, lr=LR, remat=False, p1_steps=P1_STEPS)
    b = ts.fn(params, opt, sm, _t(inputs["tok"]), _t(inputs["contact"]),
              _t(inputs["target"]), _t(inputs["prefix"]))
    assert calls == {"functional": 1, "in_place": 0}
    assert {k: x.data_ptr() for k, x in _flat(b[0]).items()} == ptrs
    assert float(a[3]["loss"]) == float(b[3]["loss"]) and torch.equal(a[2], b[2])
    for k, leaf in _flat(a[0]).items():
        assert torch.equal(_flat(b[0])[k], leaf), k


def test_round_on_the_cpu_updates_leaf_by_leaf(round_case, monkeypatch):
    """On the CPU the round's AdamW (``steps.adamw_step_``) takes
    ``steps.adamw_per_leaf_`` once per vehicle over all its leaves, and the
    kernel's launch count stays 0; the round gives the same parameters,
    moments, counters and loss, bit for bit, as one whose vehicles take
    ``optim.adamw``'s whole-tree update."""
    cfg, inputs, _, _ = round_case
    calls = []
    real = steps.adamw_per_leaf_

    def spy(optimizer, rows, *args):
        calls.append(len(rows))
        return real(optimizer, rows, *args)

    def whole_tree(optimizer, rows, mu, nu, grads, count):
        updates, new = optimizer.update(grads, AdamState(count, mu, nu), rows)
        for name, x in apply_updates(rows, updates).items():
            rows[name].copy_(x)
            mu[name].copy_(new.mu[name])
            nu[name].copy_(new.nu[name])
        grads.clear()

    monkeypatch.setattr(steps, "adamw_per_leaf_", spy)
    adamw_kernel.reset_launch_counts()
    a = _port_round(cfg, inputs)
    assert calls == [len(_flat(a[0]))] * V and adamw_kernel.launch_counts["adamw"] == 0
    monkeypatch.setattr(steps, "adamw_step_", whole_tree)
    b = _port_round(cfg, inputs)
    assert calls == [len(_flat(a[0]))] * V
    assert float(a[3]["loss"]) == float(b[3]["loss"]) and torch.equal(a[1].count, b[1].count)
    for tree in (lambda s: s[0], lambda s: s[1].mu, lambda s: s[1].nu):
        want = _flat(tree(b))
        for k, x in _flat(tree(a)).items():
            assert torch.equal(x.view(torch.int32), want[k].view(torch.int32)), k


def test_init_train_state_and_the_steps_of_serving():
    cfg = get_config("qwen3-1.7b").reduced()
    params, opt, sm = steps.init_train_state(cfg, 3, torch.Generator().manual_seed(0))
    one = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    for k, leaf in _flat(params).items():
        assert leaf.shape[0] == 3 and torch.equal(leaf[2], _flat(one)[k])
        assert torch.equal(_flat(opt.mu)[k], torch.zeros_like(leaf))
    assert opt.count.tolist() == [0, 0, 0] and opt.count.dtype == torch.int32
    assert torch.equal(sm, torch.zeros(3, 3))
    tok = torch.randint(0, cfg.true_vocab_size, (2, 10), generator=torch.Generator().manual_seed(1))
    last, state = steps.build_prefill_step(cfg).fn(one, tok)
    want_last, want_state = transformer.prefill(one, tok, cfg)
    assert torch.equal(last, want_last) and torch.equal(state.kv.k, want_state.kv.k)
    logits, _ = steps.build_decode_step(cfg).fn(one, tok[:, :1], state)
    assert torch.equal(logits, transformer.decode_step(one, tok[:, :1], want_state, cfg)[0])


# --------------------------------------------------------- the train CLI ---

def test_train_cli_transformer_checkpoint_restores_in_the_reference(tmp_path, capsys):
    params, _, sm, history = train.main(
        ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu", "--vehicles", "4",
         "--steps", "2", "--seq-len", "16", "--checkpoint-dir", str(tmp_path)])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("step")]
    assert len(lines) == 2 and len(history) == 2
    for line, m in zip(lines, history):
        assert np.isfinite(m["loss"]) and np.isfinite(m["kl"])
        assert f"loss={m['loss']:.4f}" in line and f"kl={m['kl']:.4f}" in line
    np.testing.assert_allclose(sm.numpy().sum(1), 1.0, atol=1e-5)
    like = jax.tree_util.tree_map(np.zeros_like, convert.to_numpy(params))
    restored = ref_ckpt.restore(str(tmp_path / "ckpt_2.npz"), like)
    for k, leaf in _flat(params).items():
        np.testing.assert_array_equal(np.asarray(_flat(restored)[k]), leaf.numpy())
    assert ckpt.metadata(str(tmp_path / "ckpt_2.npz")) == {"arch": "qwen3-1.7b-reduced",
                                                            "step": 2}


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES) + sorted(PORT_ONLY))
def test_train_cli_runs_every_transformer(arch, capsys):
    _, _, _, history = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                                   "--vehicles", "4", "--steps", "2", "--seq-len", "8"])
    assert len(history) == 2
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["kl"]) for m in history)
    assert capsys.readouterr().out.count("loss=") == 2
