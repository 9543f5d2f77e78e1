"""Plain reference of a DFL-DDS training round of Moonlight-16B-A3B vehicles
(deepseek_v3: latent attention, a sigmoid router with a selection-only bias,
shared experts, one leading dense layer), as the benchmark's cut holds it.

Plain PyTorch only, in blocks so that it fits on the card after the
program's state is freed: one vehicle at a time, each layer recomputed in
the backward pass (``torch.utils.checkpoint``), one expert at a time. It
imports nothing of the program and takes its inputs (initial weights,
tokens, contact, target) from the benchmark; the round's helpers (P1, the
mix, AdamW's constants, the fp8 control's products) are
``reference.granite``'s.

  x = embed[tokens]; per layer: x += mla(rms(x)); x += ffn(rms(x))
  mla: q = y wq, per head [q_nope 128 ; q_pe 64]; [c ; k_pe] = y wkv_a,
       c = rms(c) kv_norm; [k_nope ; v] = c wkv_b per head; rotary (theta
       50,000) on q_pe and on the one k_pe of all heads, each pair
       (2i, 2i + 1) turned as a complex number; scores q_nope.k_nope +
       q_pe.k_pe over sqrt(192), causal softmax, o = p v (128 wide), o wo
  ffn, layer 0: SwiGLU of width 11,264
  ffn, MoE layers: s = sigmoid(y W_r) over the router's 64 experts; the
       top 6 of s + b; g = s[top] / sum s[top] x 2.446; the held experts'
       part sum_{i in top, held} g_i SwiGLU_i(y), plus the shared SwiGLU
       (2 x 1,408 wide); DeepSeek-V3's sequence-wise balance loss over all
       64 experts (per sequence sum_i f_i P_i, f_i = 64 / (6 T) x the
       tokens choosing i by the top 6 of s + b, P_i the mean of
       s_i / sum_j s_j), summed over layers, weighed 0.001
  loss: mean next-token cross-entropy over lm_head (untied) + the aux

Departures from the published model, the program's alike: 7 of 27 layers
and, of each MoE layer's 64 experts, experts 0-7 alone (the benchmark's
deployment: the other experts' part lies on other chips and is left out);
the bias b is drawn from the seed and held (DeepSeek-V3 moves it by a
fixed step from the experts' load after each step; no gradient reaches it,
so AdamW leaves it too); the aux weight 0.001 is assumed (the config has
no ``aux_loss_alpha``); the balance loss's f_i counts the biased selection
that the layer runs, as Megatron-style implementations do, where
DeepSeek-V3's eq. 18 writes the top-k of s alone; no dropout; random
weights.

``mode``: ``"f32"`` (TF32 off), or ``"fp8"``, the control: every matrix
product's operands and the gossip payload rounded to float8
(``granite.product``). ``fault``: a planted fault the comparison has to
catch: ``"k_pe_unrotated"``, ``"weights_from_biased"`` (the routed weights
taken from s + b), ``"no_shared"`` (the shared experts left out),
``"weights_unchanged"`` (AdamW's moments advance, its step is not applied).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import federation as fed_ref
from . import granite

AUX_WEIGHT, NORM_EPS = 0.001, 1e-5
# the routed experts' stacks, [MoE layers, held experts, ...]
EXPERT_LEAVES = ("blocks/moe/w_gate", "blocks/moe/w_up", "blocks/moe/w_down")


def _rms(x, w):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + NORM_EPS) * w


def _rotate_pairs(x, theta):
    """x [b, s, n, r]: each pair (2i, 2i + 1) as a complex number turned by
    position x theta ** (-2i / r); returned in place order."""
    s, r = x.shape[1], x.shape[-1]
    freqs = theta ** (-torch.arange(0, r, 2, device=x.device, dtype=torch.float64) / r)
    ang = torch.arange(s, device=x.device, dtype=torch.float64)[:, None] * freqs
    turn = torch.polar(torch.ones_like(ang), ang).to(torch.complex64)[:, None]   # s 1 r/2
    z = torch.view_as_complex(x.float().reshape(*x.shape[:-1], r // 2, 2).contiguous())
    return torch.view_as_real(z * turn).reshape(x.shape)


def _attention(y, p: dict, cfg: dict, mm, fault):
    b, s, _ = y.shape
    h, r, rope = cfg["num_attention_heads"], cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    nope, vd = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
    q = mm(y, p["wq"]).view(b, s, h, nope + rope)
    ckv = mm(y, p["wkv_a"])
    c = _rms(ckv[..., :r], p["kv_norm"])
    kv = mm(c, p["wkv_b"]).view(b, s, h, nope + vd)
    q_pe = _rotate_pairs(q[..., nope:], cfg["rope_theta"])
    k_pe = ckv[..., r:][:, :, None]
    if fault != "k_pe_unrotated":
        k_pe = _rotate_pairs(k_pe, cfg["rope_theta"])
    heads = lambda t: t.permute(0, 2, 1, 3)                                # b h s .
    scores = (mm(heads(q[..., :nope]), heads(kv[..., :nope]).transpose(-1, -2))
              + mm(heads(q_pe), heads(k_pe).expand(b, h, s, rope).transpose(-1, -2)))
    causal = torch.ones(s, s, dtype=torch.bool, device=y.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")) * (nope + rope) ** -0.5, -1)
    del scores
    out = mm(probs, heads(kv[..., nope:]))                                  # b h s vd
    return mm(out.permute(0, 2, 1, 3).reshape(b, s, h * vd), p["wo"])


def _swiglu(y, w_gate, w_up, w_down, mm):
    return mm(F.silu(mm(y, w_gate)) * mm(y, w_up), w_down)


def _moe(y, p: dict, cfg: dict, mm, fault):
    b, s, d = y.shape
    e, k = cfg["router_experts"], cfg["num_experts_per_tok"]
    flat = y.reshape(b * s, d)
    scores = torch.sigmoid(mm(flat, p["router"]))                          # N e
    biased = scores + p["router_bias"]
    top = biased.topk(k, -1).indices
    weights = (biased if fault == "weights_from_biased" else scores).gather(1, top)
    weights = weights / weights.sum(-1, keepdim=True) * cfg["routed_scaling_factor"]
    aux = 0.0
    for seq in range(b):
        rows = slice(seq * s, (seq + 1) * s)
        f = torch.zeros(e, device=y.device).index_add_(
            0, top[rows].reshape(-1), torch.ones(s * k, device=y.device)) * e / (k * s)
        share = (scores[rows] / scores[rows].sum(-1, keepdim=True)).mean(0)
        aux = aux + (f * share).sum() / b
    out = torch.zeros_like(flat)
    for j in range(cfg["n_routed_experts"]):          # the held experts, ids 0..
        rows, slot = (top == j).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        he = _swiglu(flat[rows], p["w_gate"][j], p["w_up"][j], p["w_down"][j], mm)
        out = out.index_add(0, rows, he * weights[rows, slot, None])
    if fault != "no_shared":
        out = out + _swiglu(flat, p["shared_gate"], p["shared_up"], p["shared_down"], mm)
    return out.view(b, s, d), aux


def _layer(x, p: dict, cfg: dict, mm, fault, dense: bool):
    x = x + _attention(_rms(x, p["norm1"]), p, cfg, mm, fault)
    y = _rms(x, p["norm2"])
    if dense:
        return x + _swiglu(y, p["w_gate"], p["w_up"], p["w_down"], mm), torch.zeros(())
    out, aux = _moe(y, p, cfg, mm, fault)
    return x + out, aux


ATTN = {"norm1": "norm1", "norm2": "norm2", "wq": "attn/wq", "wkv_a": "attn/wkv_a",
        "kv_norm": "attn/kv_norm", "wkv_b": "attn/wkv_b", "wo": "attn/wo"}
DENSE = dict(ATTN, w_gate="mlp/w_gate", w_up="mlp/w_up", w_down="mlp/w_down")
MOE = dict(ATTN, router="moe/router", router_bias="moe/router_bias", w_gate="moe/w_gate",
           w_up="moe/w_up", w_down="moe/w_down", shared_gate="moe/shared/w_gate",
           shared_up="moe/shared/w_up", shared_down="moe/shared/w_down")


def _layers(params: dict, cfg: dict):
    """Each layer's leaves by the reference's names, and whether it is dense."""
    l0 = cfg["first_k_dense_replace"]
    for i in range(cfg["num_hidden_layers"]):
        stack, names, at = (("dense_blocks", DENSE, i) if i < l0 else ("blocks", MOE, i - l0))
        yield {n: params[f"{stack}/{path}"][at] for n, path in names.items()}, i < l0


def loss(params: dict, tokens: torch.Tensor, cfg: dict, mode: str = "f32",
         fault: str | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy + 0.001 x the layers' balance losses of
    one vehicle's weights (``params``: flat ``{path: leaf}``) on ``tokens``
    ``[B, S]``."""
    mm = granite.product(mode)
    x = params["embed"][tokens]
    aux = torch.zeros((), device=x.device)
    for layer, dense in _layers(params, cfg):
        x, a = checkpoint(_layer, x, layer, cfg, mm, fault, dense, use_reentrant=False)
        aux = aux + a.to(x.device)
    x = _rms(x, params["final_norm"])

    def head(x):
        logits = mm(x[:, :-1].reshape(-1, x.shape[-1]), params["lm_head"])
        return F.cross_entropy(logits, tokens[:, 1:].reshape(-1))
    return checkpoint(head, x, use_reentrant=False) + AUX_WEIGHT * aux


@torch.no_grad()
def bias_share(params: dict, tokens: torch.Tensor, cfg: dict) -> float:
    """The share of (token, MoE layer) pairs whose top-k the bias changes,
    over one vehicle's forward pass on ``tokens``."""
    x, changed, count = params["embed"][tokens], 0, 0
    k = cfg["num_experts_per_tok"]
    for layer, dense in _layers(params, cfg):
        if not dense:
            y = _rms(x + _attention(_rms(x, layer["norm1"]), layer, cfg, granite.product("f32"),
                                    None), layer["norm2"])
            s = torch.sigmoid(y.reshape(-1, y.shape[-1]) @ layer["router"])
            plain = s.topk(k, -1).indices.sort(-1).values
            biased = (s + layer["router_bias"]).topk(k, -1).indices.sort(-1).values
            changed += int((plain != biased).any(-1).sum())
            count += plain.shape[0]
        x, _ = _layer(x, layer, cfg, granite.product("f32"), None, dense)
    return changed / count


def dds_round(state: dict, tokens: torch.Tensor, contact: torch.Tensor, target: torch.Tensor,
              cfg: dict, lr: float, p1_steps: int, mode: str = "f32", batch_share: float = 1.0,
              fault: str | None = None):
    """One round over ``state``, as ``granite.dds_round``: P1, the mix, one
    AdamW step per vehicle (a leaf no gradient reaches gets 0), the state
    vectors' update. Returns each vehicle's loss, gradient norms by leaf,
    and gradient norms of each routed expert ``[MoE layers, held experts,
    3]`` (``EXPERT_LEAVES``)."""
    with fed_ref.precision("f32"):
        alpha = fed_ref.solve_p1(state["states"], target, contact, p1_steps, 2.0)
        w = alpha * contact
        w = w / w.sum(-1, keepdim=True).clamp(min=fed_ref.EPS)
        v_count = len(state["params"])
        with torch.no_grad():
            for name in state["params"][0]:
                mixed = granite._mix_leaf(w, [p[name] for p in state["params"]], mode)
                for p, m in zip(state["params"], mixed):
                    p[name] = m
        state["count"] += 1
        c1, c2 = 1 - granite.B1 ** state["count"], 1 - granite.B2 ** state["count"]
        losses, grads, experts = [], [], []
        for v in range(v_count):
            toks = tokens[v]
            if batch_share < 1.0:
                toks = toks[:, : max(2, int(toks.shape[1] * batch_share))]
            leaves = {n: x.detach().requires_grad_() for n, x in state["params"][v].items()}
            value = loss(leaves, toks, cfg, mode, fault)
            got = torch.autograd.grad(value, list(leaves.values()), allow_unused=True)
            g = {n: torch.zeros_like(x) if gr is None else gr
                 for (n, x), gr in zip(leaves.items(), got)}
            del leaves, got
            with torch.no_grad():
                for n, gr in g.items():
                    mu, nu = state["mu"][v][n], state["nu"][v][n]
                    mu.mul_(granite.B1).add_(gr, alpha=1 - granite.B1)
                    nu.mul_(granite.B2).addcmul_(gr, gr, value=1 - granite.B2)
                    if fault != "weights_unchanged":
                        state["params"][v][n] = state["params"][v][n] - lr * (mu / c1) / (
                            torch.sqrt(nu / c2) + granite.ADAM_EPS)
            losses.append(float(value.detach()))
            grads.append({n: float(torch.linalg.vector_norm(gr)) for n, gr in g.items()})
            experts.append(torch.stack([torch.linalg.vector_norm(g[n], dim=(-2, -1))
                                        for n in EXPERT_LEAVES], -1).cpu())
            del g
        s = w @ state["states"] + lr * torch.eye(v_count, device=w.device)
        tot = s.sum(-1, keepdim=True)
        state["states"] = torch.where(tot > fed_ref.EPS, s / tot.clamp(min=fed_ref.EPS), s)
    return losses, grads, experts
