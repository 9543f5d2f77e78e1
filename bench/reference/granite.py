"""Plain reference of a DFL-DDS training round of granite-moe vehicles.

Plain PyTorch only, in blocks so that it fits beside nothing else on the card
(it runs after the program's state is freed): one vehicle at a time, each
layer recomputed in the backward pass (``torch.utils.checkpoint``), one
expert at a time. It imports nothing of the program and takes its inputs
(initial weights, tokens, contact, target) from the benchmark.

The model is the one the program runs, which departs from the published
granite-3.0 block where the configuration file's ``departures`` say (no
embedding, attention, residual or logit multipliers; scores scaled by
``head_dim ** -0.5``; load-balance loss weighed 0.01):

  x = embed[tokens]; per layer: x += attn(rms_norm(x)); x += moe(rms_norm(x))
  attention: GQA, rotary on the two halves of each head, causal softmax
  moe: softmax router over all experts, top-k renormalised, SwiGLU experts,
       the Switch load-balance loss E * sum_e f_e p_e
  loss: mean next-token cross-entropy over the tied unembedding + 0.01 aux

One round (Alg. 1): P1 by exponentiated gradient on the state vectors, the
gossip mix, one AdamW step per vehicle (b1 0.9, b2 0.95, eps 1e-8, no weight
decay), the state vectors' update.

``precision``: ``"f32"`` (TF32 off), or ``"fp8"``, the control: every matrix
product's operands, and the gossip payload, rounded to float8 e4m3 with one
scale per tensor (gradients flowing back in e5m2), products summed in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import federation as fed_ref

B1, B2, ADAM_EPS, AUX_WEIGHT, NORM_EPS = 0.9, 0.95, 1e-8, 0.01, 1e-6


def _round_fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _round_fp8(a), _round_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, dy):
        qa, qb = ctx.saved_tensors
        qd = _round_fp8(dy, torch.float8_e5m2)
        return qd @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qd


def product(mode: str):
    return (lambda a, b: a @ b) if mode == "f32" else _Fp8Product.apply


def _rms(x, w):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + NORM_EPS) * w


def _rotary(x, theta):
    s, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device, dtype=torch.float32) / hd)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * freqs
    c, sn = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, -1)
    return torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], -1)


def _layer(x, p: dict, cfg: dict, mm):
    b, s, d = x.shape
    h, kv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    e, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    y = _rms(x, p["norm1"])
    q = _rotary(mm(y, p["wq"]).view(b, s, h, hd), cfg["rope_theta"])
    kk = _rotary(mm(y, p["wk"]).view(b, s, kv, hd), cfg["rope_theta"])
    v = mm(y, p["wv"]).view(b, s, kv, hd)
    q = q.view(b, s, kv, h // kv, hd).permute(0, 2, 3, 1, 4)        # b kv g s hd
    kt = kk.permute(0, 2, 3, 1)[:, :, None]                          # b kv 1 hd s
    scores = mm(q, kt) * hd ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    out = mm(probs, v.permute(0, 2, 1, 3)[:, :, None])               # b kv g s hd
    x = x + mm(out.permute(0, 3, 1, 2, 4).reshape(b, s, h * hd), p["wo"])
    y = _rms(x, p["norm2"]).reshape(b * s, d)
    router = torch.softmax(mm(y, p["router"]), -1)
    top, idx = router.topk(k, -1)
    top = top / top.sum(-1, keepdim=True).clamp(min=1e-9)
    aux = e * (F.one_hot(idx, e).float().sum(1).mean(0) * router.mean(0)).sum()
    moe = torch.zeros_like(y)
    for j in range(e):
        rows, slot = (idx == j).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = y[rows]
        he = F.silu(mm(xe, p["w_gate"][j])) * mm(xe, p["w_up"][j])
        moe = moe.index_add(0, rows, mm(he, p["w_down"][j]) * top[rows, slot, None])
    return x + moe.view(b, s, d), aux


LAYER_LEAVES = {"norm1": "blocks/norm1", "norm2": "blocks/norm2", "wq": "blocks/attn/wq",
                "wk": "blocks/attn/wk", "wv": "blocks/attn/wv", "wo": "blocks/attn/wo",
                "router": "blocks/moe/router", "w_gate": "blocks/moe/w_gate",
                "w_up": "blocks/moe/w_up", "w_down": "blocks/moe/w_down"}


def loss(params: dict, tokens: torch.Tensor, cfg: dict, mode: str = "f32") -> torch.Tensor:
    """Mean next-token cross-entropy + 0.01 x the layers' load-balance loss
    of one vehicle's weights (``params``: flat ``{path: leaf}``) on ``tokens``
    ``[B, S]``."""
    mm = product(mode)
    x = params["embed"][tokens]
    aux = torch.zeros((), device=x.device)
    for i in range(cfg["num_hidden_layers"]):
        layer = {n: params[path][i] for n, path in LAYER_LEAVES.items()}
        x, a = checkpoint(_layer, x, layer, cfg, mm, use_reentrant=False)
        aux = aux + a
    x = _rms(x, params["final_norm"])

    def head(x):
        logits = mm(x[:, :-1].reshape(-1, x.shape[-1]), params["embed"].T)
        return F.cross_entropy(logits, tokens[:, 1:].reshape(-1))
    return checkpoint(head, x, use_reentrant=False) + AUX_WEIGHT * aux


def _mix_leaf(w: torch.Tensor, leaves: list, mode: str) -> list:
    if mode != "f32":
        w = _round_fp8(w)
        leaves = [_round_fp8(x) for x in leaves]
    return [sum(w[i, j] * leaves[j] for j in range(len(leaves))) for i in range(len(leaves))]


def dds_round(state: dict, tokens: torch.Tensor, contact: torch.Tensor, target: torch.Tensor,
              cfg: dict, lr: float, p1_steps: int, mode: str = "f32", batch_share: float = 1.0):
    """One round over ``state`` (``params`` / ``mu`` / ``nu``: one flat dict
    per vehicle, ``count``, ``states`` ``[V, V]``), updated in place.
    Returns each vehicle's loss and gradient. ``batch_share`` < 1 trains on
    that share of each vehicle's tokens (a planted fault)."""
    with fed_ref.precision("f32"):
        alpha = fed_ref.solve_p1(state["states"], target, contact, p1_steps, 2.0)
        w = alpha * contact
        w = w / w.sum(-1, keepdim=True).clamp(min=fed_ref.EPS)
        v_count = len(state["params"])
        with torch.no_grad():
            for name in state["params"][0]:
                mixed = _mix_leaf(w, [p[name] for p in state["params"]], mode)
                for p, m in zip(state["params"], mixed):
                    p[name] = m
        state["count"] += 1
        c1, c2 = 1 - B1 ** state["count"], 1 - B2 ** state["count"]
        losses, grads = [], []
        for v in range(v_count):
            toks = tokens[v]
            if batch_share < 1.0:
                toks = toks[:, : max(2, int(toks.shape[1] * batch_share))]
            leaves = {n: x.detach().requires_grad_() for n, x in state["params"][v].items()}
            value = loss(leaves, toks, cfg, mode)
            g = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()))))
            del leaves
            with torch.no_grad():
                for n, gr in g.items():
                    mu, nu = state["mu"][v][n], state["nu"][v][n]
                    mu.mul_(B1).add_(gr, alpha=1 - B1)
                    nu.mul_(B2).addcmul_(gr, gr, value=1 - B2)
                    state["params"][v][n] = state["params"][v][n] - lr * (mu / c1) / (
                        torch.sqrt(nu / c2) + ADAM_EPS)
            losses.append(float(value.detach()))
            grads.append({n: float(torch.linalg.vector_norm(gr)) for n, gr in g.items()})
            del g
        s = w @ state["states"] + lr * torch.eye(v_count, device=w.device)
        tot = s.sum(-1, keepdim=True)
        state["states"] = torch.where(tot > fed_ref.EPS, s / tot.clamp(min=fed_ref.EPS), s)
    return losses, grads
