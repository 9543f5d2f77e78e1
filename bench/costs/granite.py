"""Operations of a granite-moe training round, counted from the
configuration's shapes (the algorithm's work, whatever implements it).

6 x the parameters a token passes through in matrix products (attention's
four projections, the router, its top-k experts' three products, the tied
unembedding; the embedding lookup is no product) per trained token, plus
causal attention's score and value products, 6 x L x d_attn x S per token.
Remat's recompute and padding are not counted."""


def active_matmul_params(cfg: dict) -> int:
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    h, kv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    router = d * cfg["num_local_experts"]
    experts = cfg["num_experts_per_tok"] * 3 * d * cfg["intermediate_size"]
    return L * (attn + router + experts) + cfg["vocab_size"] * d


def token_flops(cfg: dict, seq: int) -> float:
    """Forward and backward operations per trained token at length ``seq``."""
    d_attn = cfg["num_attention_heads"] * cfg["head_dim"]
    return 6 * active_matmul_params(cfg) + 6 * cfg["num_hidden_layers"] * d_attn * seq


def round_flops(cfg: dict, vehicles: int, batch: int, seq: int, local_steps: int = 1) -> float:
    """One DDS round: every vehicle trains ``local_steps`` steps on B x S
    tokens."""
    return vehicles * local_steps * batch * seq * token_flops(cfg, seq)
