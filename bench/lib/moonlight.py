"""Moonlight's inputs, made from ``--seed`` for both the program and the
reference: the leaves of one vehicle's weights (the program's tree, flat by
``/``-joined path; per-layer leaves stacked on a leading layer axis, the
leading dense layers on ``dense_blocks``, the MoE layers on ``blocks``), each
drawn on its own from ``(seed, index)``. Tokens are ``inputs.granite_tokens``
(uniform over the configuration's vocabulary).

Sizes come from the configuration file's keys: ``num_hidden_layers`` layers
of which ``first_k_dense_replace`` dense, ``n_routed_experts`` experts held
here out of the router's ``router_experts``.
"""
from __future__ import annotations

from . import inputs

# std of the router's selection bias: the gap between the 6th and 7th of 64
# sigmoid scores is about 0.016 at these weights, so most tokens' top-6 moves
ROUTER_BIAS_STD = 0.05


def sizes(cfg: dict) -> dict:
    """The model's sizes by the program's names."""
    rope = cfg["qk_rope_head_dim"]
    return {"L0": cfg["first_k_dense_replace"],
            "L1": cfg["num_hidden_layers"] - cfg["first_k_dense_replace"],
            "d": cfg["hidden_size"], "h": cfg["num_attention_heads"],
            "nope": cfg["qk_nope_head_dim"], "rope": rope, "vd": cfg["v_head_dim"],
            "r": cfg["kv_lora_rank"], "F": cfg["intermediate_size"],
            "f": cfg["moe_intermediate_size"], "E": cfg["router_experts"],
            "held": cfg["n_routed_experts"], "shared": cfg["n_shared_experts"],
            "V": cfg["vocab_size"]}


def leaves(cfg: dict) -> list[tuple[str, tuple, float | None]]:
    """``(path, shape, std)`` of every leaf; std None is a norm weight
    (ones)."""
    z = sizes(cfg)
    d, h, r, rope = z["d"], z["h"], z["r"], z["rope"]
    hd = z["nope"] + rope

    def attn(stack: str, n: int) -> list:
        return [(f"{stack}/norm1", (n, d), None), (f"{stack}/norm2", (n, d), None),
                (f"{stack}/attn/wq", (n, d, h * hd), d ** -0.5),
                (f"{stack}/attn/wkv_a", (n, d, r + rope), d ** -0.5),
                (f"{stack}/attn/kv_norm", (n, r), None),
                (f"{stack}/attn/wkv_b", (n, r, h * (z["nope"] + z["vd"])), r ** -0.5),
                (f"{stack}/attn/wo", (n, h * z["vd"], d), (h * z["vd"]) ** -0.5)]

    L0, L1, F, f, fs = z["L0"], z["L1"], z["F"], z["f"], z["shared"] * z["f"]
    out = [("embed", (z["V"], d), 0.02)]
    if L0:
        out += attn("dense_blocks", L0) + [
            ("dense_blocks/mlp/w_gate", (L0, d, F), d ** -0.5),
            ("dense_blocks/mlp/w_up", (L0, d, F), d ** -0.5),
            ("dense_blocks/mlp/w_down", (L0, F, d), F ** -0.5)]
    out += attn("blocks", L1) + [
        ("blocks/moe/router", (L1, d, z["E"]), d ** -0.5),
        ("blocks/moe/router_bias", (L1, z["E"]), ROUTER_BIAS_STD),
        ("blocks/moe/w_gate", (L1, z["held"], d, f), d ** -0.5),
        ("blocks/moe/w_up", (L1, z["held"], d, f), d ** -0.5),
        ("blocks/moe/w_down", (L1, z["held"], f, d), f ** -0.5),
        ("blocks/moe/shared/w_gate", (L1, d, fs), d ** -0.5),
        ("blocks/moe/shared/w_up", (L1, d, fs), d ** -0.5),
        ("blocks/moe/shared/w_down", (L1, fs, d), fs ** -0.5),
        ("final_norm", (d,), None), ("lm_head", (d, z["V"]), d ** -0.5)]
    return out


def leaf(cfg: dict, seed: int, index: int, device, out=None):
    """Leaf ``index`` of ``leaves`` drawn from ``(seed, index)``: one call,
    written into ``out`` when given."""
    import torch

    path, shape, std = leaves(cfg)[index]
    if out is None:
        out = torch.empty(shape, device=device)
    if std is None:
        return out.fill_(1.0)
    g = inputs.generator(device, seed, stream=100 + index)
    torch.randn(shape, generator=g, device=device, out=out)
    return out.mul_(std)
