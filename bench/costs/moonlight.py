"""Operations of a Moonlight training round as this chip's cut holds it,
counted from the configuration's shapes (the algorithm's work, whatever
implements it).

6 x the parameters a token passes through in matrix products (latent
attention's five projections in every layer, the dense layer's SwiGLU, in
each MoE layer the router, the shared experts and the held share of its
top-k routed experts, k x held / router experts, and the untied head; the
embedding lookup is no product) per trained token, plus causal attention's
score and value products, 3 x H x (q/k head width + v head width) x S per
layer and token. Remat's recompute and padding are not counted."""


def active_matmul_params(cfg: dict) -> float:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    r, rope, nope = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"], cfg["qk_nope_head_dim"]
    vd, f = cfg["v_head_dim"], cfg["moe_intermediate_size"]
    l0 = cfg["first_k_dense_replace"]
    l1 = cfg["num_hidden_layers"] - l0
    attn = d * h * (nope + rope) + d * (r + rope) + r * h * (nope + vd) + h * vd * d
    dense = 3 * d * cfg["intermediate_size"]
    routed = (cfg["num_experts_per_tok"] * cfg["n_routed_experts"] / cfg["router_experts"]
              * 3 * d * f)
    moe = d * cfg["router_experts"] + cfg["n_shared_experts"] * 3 * d * f + routed
    return (l0 + l1) * attn + l0 * dense + l1 * moe + cfg["vocab_size"] * d


def token_flops(cfg: dict, seq: int) -> float:
    """Forward and backward operations per trained token at length ``seq``."""
    h, width = cfg["num_attention_heads"], (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
                                            + cfg["v_head_dim"])
    return 6 * active_matmul_params(cfg) + 3 * cfg["num_hidden_layers"] * h * width * seq


def round_flops(cfg: dict, vehicles: int, batch: int, seq: int, local_steps: int = 1) -> float:
    """One DDS round: every vehicle trains ``local_steps`` steps on B x S
    tokens."""
    return vehicles * local_steps * batch * seq * token_flops(cfg, seq)
