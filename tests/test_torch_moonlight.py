"""Moonlight-16B-A3B (deepseek_v3, a port-only architecture) against a plain
reference at small widths on the CPU, in f32: latent attention, the sigmoid
router with its selection-only bias, shared experts, the leading dense
layer, the expert share, the whole loss and one ``build_dds_train_step``
round. The reference below is the tests' copy; ``bench/reference/moonlight``
is the benchmark's, written apart, and the two are held equal here. Every
comparison is to 1e-5 of the compared quantity's scale."""
from __future__ import annotations

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from bench.reference import granite as bench_granite
from bench.reference import moonlight as bench_ref
from repro_torch.configs import ALL_CONFIGS, ARCHITECTURES, PORT_ONLY, get_config
from repro_torch.configs.base import DeepseekV3Config
from repro_torch.launch import steps
from repro_torch.models import attention, moe, transformer
from repro_torch.optim import AdamState
from repro_torch.profiling import PhaseTimer

# the configuration's keys (bench/configs/moonlight-16b-a3b.json) at small widths
C = {"num_hidden_layers": 3, "first_k_dense_replace": 1, "hidden_size": 64,
     "num_attention_heads": 4, "kv_lora_rank": 16, "qk_nope_head_dim": 16,
     "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 96,
     "moe_intermediate_size": 32, "router_experts": 8, "n_routed_experts": 4,
     "num_experts_per_tok": 2, "n_shared_experts": 2, "vocab_size": 128, "rope_theta": 50000.0,
     "rms_norm_eps": 1e-5, "routed_scaling_factor": 2.446}
HELD = (0, 4)


def program_cfg(expert_range=HELD, **kw) -> DeepseekV3Config:
    return dataclasses.replace(
        get_config("moonlight-16b-a3b"), num_layers=C["num_hidden_layers"], d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=24, kv_lora_rank=16, qk_rope_dim=8, v_head_dim=16,
        d_ff=32, dense_d_ff=96, vocab_size=128, true_vocab_size=128, true_num_heads=4,
        true_num_kv_heads=4, num_experts=8, top_k=2, expert_range=expert_range, **kw)


def close(got, want, tol=1e-5):
    got, want = got.detach(), want.detach()
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= tol * scale, float((got - want).abs().max()) / scale


def draw(cfg, seed=0) -> dict:
    """One vehicle's weights, flat by path (the router bias as drawn)."""
    return steps.flatten(transformer.init_params(torch.Generator().manual_seed(seed), cfg))


# ----------------------------------------------- the plain reference, tests' copy

def ref_rms(x, w):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + C["rms_norm_eps"]) * w


def ref_rope(x):
    """x [b, s, n, r]: pair (2i, 2i + 1) turned by position x theta ** (-2i / r),
    laid out [evens ; odds]."""
    s, r = x.shape[1], x.shape[-1]
    inv = 1.0 / C["rope_theta"] ** (torch.arange(0, r, 2, dtype=torch.float32) / r)
    ang = torch.arange(s, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    ev, od = x[..., 0::2], x[..., 1::2]
    return torch.cat([ev * cos - od * sin, od * cos + ev * sin], -1)


def ref_mla(y, p):
    b, s, _ = y.shape
    h, r, rope = C["num_attention_heads"], C["kv_lora_rank"], C["qk_rope_head_dim"]
    nope, vd = C["qk_nope_head_dim"], C["v_head_dim"]
    q = (y @ p["wq"]).view(b, s, h, nope + rope)
    ckv = y @ p["wkv_a"]
    kv = (ref_rms(ckv[..., :r], p["kv_norm"]) @ p["wkv_b"]).view(b, s, h, nope + vd)
    k_pe = ref_rope(ckv[..., r:].view(b, s, 1, rope)).expand(b, s, h, rope)
    qq = torch.cat([q[..., :nope], ref_rope(q[..., nope:])], -1).transpose(1, 2)
    kk = torch.cat([kv[..., :nope], k_pe], -1).transpose(1, 2)
    logits = qq @ kk.transpose(-1, -2) / (nope + rope) ** 0.5
    logits = logits.masked_fill(torch.ones(s, s).triu(1).bool(), float("-inf"))
    o = torch.softmax(logits, -1) @ kv[..., nope:].transpose(1, 2)
    return o.transpose(1, 2).reshape(b, s, h * vd) @ p["wo"]


def ref_route(x, p, batch):
    """(top ids [N, k], weights [N, k], aux) of rows x [N, d] in ``batch``
    sequences. The balance loss counts the biased selection (a listed
    departure: DeepSeek-V3's eq. 18 counts the top-k of s alone)."""
    e, k = C["router_experts"], C["num_experts_per_tok"]
    s = torch.sigmoid(x @ p["router"])
    top = torch.topk(s + p["router_bias"], k).indices
    g = s.gather(1, top)
    g = g / g.sum(-1, keepdim=True) * C["routed_scaling_factor"]
    hits = F.one_hot(top, e).float().sum(1).view(batch, -1, e)
    f = hits.mean(1) * e / k
    share = (s / s.sum(-1, keepdim=True)).view(batch, -1, e).mean(1)
    return top, g, (f * share).sum(-1).mean()


def ref_swiglu(x, a, b, c):
    return (F.silu(x @ a) * (x @ b)) @ c


def ref_moe(y, p, lo, hi):
    """(routed part of experts lo..hi-1, shared part, aux) of y [B, S, d];
    ``p`` holds experts lo..hi-1."""
    b, s, d = y.shape
    x = y.reshape(b * s, d)
    top, g, aux = ref_route(x, p, b)
    routed = torch.zeros_like(x)
    for e in range(lo, hi):
        for slot in range(top.shape[1]):
            rows = top[:, slot] == e
            out = ref_swiglu(x[rows], p["w_gate"][e - lo], p["w_up"][e - lo], p["w_down"][e - lo])
            routed = routed.index_put((rows.nonzero()[:, 0],), out * g[rows, slot, None],
                                      accumulate=True)
    shared = ref_swiglu(x, p["shared/w_gate"], p["shared/w_up"], p["shared/w_down"])
    return routed.view(b, s, d), shared.view(b, s, d), aux


def layer_of(flat, i):
    l0 = C["first_k_dense_replace"]
    stack, at = ("dense_blocks", i) if i < l0 else ("blocks", i - l0)
    pre = f"{stack}/"
    p = {n[len(pre):]: x[at] for n, x in flat.items() if n.startswith(pre)}
    return {n.split("/", 1)[1] if n.startswith(("attn/", "mlp/", "moe/")) else n: x
            for n, x in p.items()}, i < l0


def ref_loss(flat, tokens, lo=HELD[0], hi=HELD[1], aux_weight=0.001):
    x = flat["embed"][tokens]
    aux = 0.0
    for i in range(C["num_hidden_layers"]):
        p, dense = layer_of(flat, i)
        x = x + ref_mla(ref_rms(x, p["norm1"]), p)
        y = ref_rms(x, p["norm2"])
        if dense:
            x = x + ref_swiglu(y, p["w_gate"], p["w_up"], p["w_down"])
        else:
            routed, shared, a = ref_moe(y, p, lo, hi)
            x, aux = x + routed + shared, aux + a
    logits = ref_rms(x, flat["final_norm"]) @ flat["lm_head"]
    ce = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
    return ce + aux_weight * aux


# -------------------------------------------------------------------- tests

def test_registry_and_config():
    cfg = get_config("moonlight-16b-a3b")
    assert isinstance(cfg, DeepseekV3Config) and set(PORT_ONLY) == {"moonlight-16b-a3b"}
    assert cfg.name not in ARCHITECTURES and cfg.name not in ALL_CONFIGS
    assert len(ARCHITECTURES) == 10
    # the ten keep the reference's fields; the port-only options are neutral there
    for c in ALL_CONFIGS.values():
        assert type(c) is not DeepseekV3Config
        assert (c.kv_lora_rank, c.first_dense_layers, c.shared_experts, c.router,
                c.expert_range, c.aux_weight) == (0, 0, 0, "softmax", None, 0.01)
        assert c.held_experts == (0, c.num_experts) and c.value_dim == c.head_dim
    assert (cfg.head_dim, cfg.value_dim, cfg.d_ff, cfg.dense_d_ff) == (192, 128, 1408, 11264)
    # 15.96 B parameters published whole; the benchmark's cut 1.357 B
    assert 15.9e9 < cfg.param_count() < 16.0e9
    cut = dataclasses.replace(cfg, num_layers=7, expert_range=(0, 8))
    meta = transformer.init_params(torch.Generator(), cut, device="meta")
    assert sum(x.numel() for x in steps.flatten(meta).values()) == cut.param_count()
    assert cut.param_count() == 1_356_498_816
    with pytest.raises(NotImplementedError):
        transformer.init_decode_state(cut, 1, 8)


def test_mla_forward_and_gradients():
    cfg = program_cfg()
    p, _ = layer_of(draw(cfg), 1)
    attn = {n: p[n].clone().requires_grad_() for n in ("wq", "wkv_a", "kv_norm", "wkv_b", "wo")}
    attn["kv_norm"].data.uniform_(0.5, 1.5)
    x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(1), requires_grad=True)
    got = attention.attention(attn, x, cfg)
    want = ref_mla(x, attn)
    assert got.shape == (2, 16, 64)
    close(got, want)
    dy = torch.randn_like(want)
    g1 = torch.autograd.grad(got, [x, *attn.values()], dy)
    g2 = torch.autograd.grad(want, [x, *attn.values()], dy)
    for a, b in zip(g1, g2):
        close(a, b)


def test_sdpa_takes_the_value_head_width():
    q, k = torch.randn(1, 5, 2, 24), torch.randn(1, 5, 2, 24)
    v = torch.randn(1, 5, 2, 16)
    mask = torch.ones(5, 5).tril().bool()
    out = attention._sdpa(q, k, v, mask, 24 ** -0.5)
    assert out.shape == (1, 5, 2, 16)
    close(attention.blocked_sdpa(q, k, v, None, 24 ** -0.5, block=2), out)


def test_router_selection_weights_and_balance_loss():
    cfg = program_cfg()
    p, _ = layer_of(draw(cfg), 1)
    x = torch.randn(2 * 16, 64, generator=torch.Generator().manual_seed(2))
    w, idx, aux = moe.router_sigmoid(x @ p["router"], p["router_bias"], 2, 2.446, batch=2)
    top, g, want_aux = ref_route(x, p, 2)
    assert torch.equal(idx, top)
    close(w, g)
    close(aux, want_aux)
    # the bias moves the choice of some tokens, and weighs nothing
    plain = torch.topk(torch.sigmoid(x @ p["router"]), 2).indices
    assert (plain.sort(-1).values != idx.sort(-1).values).any(-1).float().mean() >= 0.1
    close(w.sum(-1), torch.full((32,), 2.446))


@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_moe_layer_with_shared_experts(impl):
    cfg = program_cfg(moe_impl=impl)
    p, _ = layer_of(draw(cfg), 2)
    y = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(3))
    got, aux = moe.moe_ffn(steps.unflatten(p), y, cfg)
    routed, shared, want_aux = ref_moe(y, p, *HELD)
    close(got, routed + shared)
    close(aux, want_aux)


def test_ragged_matches_dense_with_gradients():
    outs = []
    for impl in ("dense", "ragged"):
        cfg = program_cfg(moe_impl=impl)
        p, _ = layer_of(draw(cfg), 1)
        leaves = {n: x.clone().requires_grad_() for n, x in steps.flatten(p).items()}
        y = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(4))
        out, aux = moe.moe_ffn(steps.unflatten(leaves), y, cfg)
        (out.square().sum() + aux).backward()
        outs.append((out, aux, {n: x.grad for n, x in leaves.items()}))
    (a, aux_a, ga), (b, aux_b, gb) = outs
    close(b, a)
    close(aux_b, aux_a)
    assert ga["router_bias"] is None and gb["router_bias"] is None     # it selects only
    for n in ("router", "w_gate", "w_up", "w_down", "shared/w_gate", "shared/w_up",
              "shared/w_down"):
        close(gb[n], ga[n])


def test_the_shares_add_up_to_the_uncut_layer():
    """Eight chips of one expert each: their routed parts, with the shared
    experts counted once, are the layer that holds all eight."""
    whole_cfg = program_cfg(expert_range=None)
    p, _ = layer_of(draw(whole_cfg), 1)
    y = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(5))
    whole, aux = moe.moe_ffn(steps.unflatten(p), y, whole_cfg)
    shared = ref_swiglu(y, p["shared/w_gate"], p["shared/w_up"], p["shared/w_down"])
    total = shared.clone()
    for e in range(8):
        cfg = program_cfg(expert_range=(e, e + 1), moe_impl="ragged" if e % 2 else "dense")
        share = dict(p, **{n: p[n][e:e + 1] for n in ("w_gate", "w_up", "w_down")})
        out, aux_e = moe.moe_ffn(steps.unflatten(share), y, cfg)
        close(aux_e, aux)
        total = total + (out - shared)
    close(total, whole)
    routed, ref_shared, _ = ref_moe(y, p, 0, 8)
    close(whole, routed + ref_shared)


@pytest.mark.parametrize("remat", [False, True])
def test_whole_model_loss_and_gradients(remat):
    cfg = program_cfg()
    flat = draw(cfg)
    tokens = torch.randint(0, 128, (2, 16), generator=torch.Generator().manual_seed(6))
    leaves = {n: x.clone().requires_grad_() for n, x in flat.items()}
    got = transformer.lm_loss(steps.unflatten(leaves), tokens, cfg, remat=remat)
    want = ref_loss(leaves, tokens)
    close(got, want)
    g1 = torch.autograd.grad(got, list(leaves.values()), allow_unused=True,
                             materialize_grads=True)
    g2 = torch.autograd.grad(want, list(leaves.values()), allow_unused=True,
                             materialize_grads=True)
    for name, a, b in zip(leaves, g1, g2):
        if name.endswith("router_bias"):
            assert torch.count_nonzero(a) == 0 and torch.count_nonzero(b) == 0
        else:
            close(a, b)


def test_the_benchmark_copy_of_the_reference_agrees():
    cfg = program_cfg()
    flat = draw(cfg)
    tokens = torch.randint(0, 128, (2, 16), generator=torch.Generator().manual_seed(7))
    leaves = {n: x.clone().requires_grad_() for n, x in flat.items()}
    ours, theirs = ref_loss(leaves, tokens), bench_ref.loss(leaves, tokens, C)
    close(theirs, ours)
    g1 = torch.autograd.grad(ours, list(leaves.values()), allow_unused=True,
                             materialize_grads=True)
    g2 = torch.autograd.grad(theirs, list(leaves.values()), allow_unused=True,
                             materialize_grads=True)
    for a, b in zip(g1, g2):
        close(b, a)


def _fed(cfg, moments: bool):
    """Two vehicles from one draw, apart by a little noise; AdamW's moments
    after three steps (``moments``) or zero."""
    gen = torch.Generator().manual_seed(8)
    params, opt, sm = steps.init_train_state(cfg, 2, gen)
    flat = steps.flatten(params)
    for leaf in flat.values():
        leaf[1:].add_(0.01 * torch.randn(leaf[1:].shape, generator=gen))
    if moments:
        for mu, nu in zip(steps.flatten(opt.mu).values(), steps.flatten(opt.nu).values()):
            mu.normal_(0.0, 1e-3, generator=gen)
            nu.uniform_(0.0, 1e-6, generator=gen).add_(2 * mu * mu)
        opt.count.fill_(3)
        sm = torch.tensor([[0.7, 0.3], [0.2, 0.8]])
    tokens = torch.randint(0, 128, (2, 2, 16), generator=gen)
    return params, opt, sm, tokens


def test_one_dds_round_at_v2_against_the_reference():
    cfg = program_cfg(moe_impl="ragged")
    params, opt, sm, tokens = _fed(cfg, moments=True)
    flat, mu, nu = (steps.flatten(t) for t in (params, opt.mu, opt.nu))
    state = {"params": [{n: x[v].clone() for n, x in flat.items()} for v in range(2)],
             "mu": [{n: x[v].clone() for n, x in mu.items()} for v in range(2)],
             "nu": [{n: x[v].clone() for n, x in nu.items()} for v in range(2)],
             "count": 3, "states": sm.clone()}
    contact, target = torch.ones(2, 2), torch.full((2,), 0.5)
    ts = steps.build_dds_train_step(cfg, lr=1e-3, p1_steps=100, remat=True)
    params, opt, new_sm, metrics = ts.fn(params, opt, sm, tokens, contact, target)
    losses, _, _ = bench_ref.dds_round(state, tokens, contact, target, C, 1e-3, 100)
    close(metrics["loss"], torch.tensor(sum(losses) / 2))
    close(new_sm, state["states"])
    for n, x in steps.flatten(params).items():
        for v in range(2):
            close(x[v], state["params"][v][n])
    assert torch.equal(opt.count, torch.tensor([4, 4], dtype=torch.int32))


def test_the_router_bias_is_left_as_drawn_by_a_round():
    cfg = program_cfg(moe_impl="ragged")
    params, opt, sm, tokens = _fed(cfg, moments=False)
    bias = params["blocks"]["moe"]["router_bias"]
    bias[1].copy_(bias[0])                           # one bias, as every vehicle draws it
    before, router = bias.clone(), params["blocks"]["moe"]["router"].clone()
    ts = steps.build_dds_train_step(cfg, lr=1e-3, p1_steps=100, remat=True)
    params, opt, _, _ = ts.fn(params, opt, sm, tokens, torch.ones(2, 2), torch.full((2,), 0.5))
    assert torch.count_nonzero(opt.mu["blocks"]["moe"]["router_bias"]) == 0
    assert torch.count_nonzero(opt.nu["blocks"]["moe"]["router_bias"]) == 0
    # the mix of two equal rows, within f32 rounding
    close(params["blocks"]["moe"]["router_bias"], before, tol=2 ** -22)
    assert float((params["blocks"]["moe"]["router"] - router).abs().max()) > 1e-4   # trained


def test_the_spans_and_the_held_rows_counter():
    cfg = program_cfg(moe_impl="ragged")
    flat = draw(cfg)
    tokens = torch.randint(0, 128, (2, 16), generator=torch.Generator().manual_seed(9))
    held = 0
    x = flat["embed"][tokens]
    for i in range(C["num_hidden_layers"]):
        p, dense = layer_of(flat, i)
        x = x + ref_mla(ref_rms(x, p["norm1"]), p)
        y = ref_rms(x, p["norm2"])
        if dense:
            x = x + ref_swiglu(y, p["w_gate"], p["w_up"], p["w_down"])
            continue
        top, _, _ = ref_route(y.reshape(-1, 64), p, 2)
        held += int(((top >= HELD[0]) & (top < HELD[1])).sum())
        routed, shared, _ = ref_moe(y, p, *HELD)
        x = x + routed + shared
    for remat in (False, True):
        timer = PhaseTimer("cpu")
        leaves = {n: t.clone().requires_grad_() for n, t in flat.items()}
        transformer.lm_loss(steps.unflatten(leaves), tokens, cfg, remat=remat,
                            timer=timer).backward()
        # every forward pass counts, the recompute too
        assert timer.counts() == {"moe.held_rows": held * (2 if remat else 1)}
        assert {"mla", "moe"} <= set(timer.totals_ms())
    assert transformer.lm_loss(steps.unflatten(flat), tokens, cfg).isfinite()


@pytest.mark.parametrize("blocks", [False, True])
@pytest.mark.parametrize("arch", ["moonlight-16b-a3b", "granite-moe-1b-a400m"])
def test_the_train_step_opens_block_spans_only_when_asked(arch, blocks):
    """A timer opens the blocks' spans and the held-rows counter in the
    train step only with ``blocks``; a GQA block opens none of its own."""
    cfg = program_cfg(moe_impl="ragged") if arch == "moonlight-16b-a3b" \
        else get_config(arch).reduced()
    params, opt, sm = steps.init_train_state(cfg, 2, torch.Generator().manual_seed(11))
    timer = PhaseTimer("cpu", blocks=blocks)
    ts = steps.build_dds_train_step(cfg, lr=1e-3, p1_steps=5, remat=True, timer=timer)
    tokens = torch.randint(0, cfg.vocab_size, (2, 1, 8), generator=torch.Generator())
    ts.fn(params, opt, sm, tokens, torch.ones(2, 2), torch.full((2,), 0.5))
    names = set(timer.totals_ms())
    assert {"local_train", "forward", "backward"} <= names
    want = ({"mla", "moe"} if arch == "moonlight-16b-a3b" else {"moe"}) if blocks else set()
    assert names & {"mla", "moe", "attention"} == want
    assert set(timer.counts()) == ({"moe.held_rows"} if blocks else set())


def test_an_uncut_moonlight_round_runs_with_adamw_state():
    cfg = get_config("moonlight-16b-a3b").reduced()
    params, opt, sm = steps.init_train_state(cfg, 2, torch.Generator().manual_seed(10))
    assert "dense_blocks" in params and isinstance(opt, AdamState)
    ts = steps.build_dds_train_step(cfg, lr=1e-3, p1_steps=20, remat=False)
    tokens = torch.randint(0, cfg.vocab_size, (2, 1, 8), generator=torch.Generator())
    _, _, sm, metrics = ts.fn(params, opt, sm, tokens, torch.ones(2, 2), torch.full((2,), 0.5))
    assert metrics["loss"].isfinite() and torch.allclose(sm.sum(1), torch.ones(2))
    assert bench_granite.B1 == 0.9                    # the round's AdamW, as the reference's
