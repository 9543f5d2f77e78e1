"""moonlight-16b-a3b [moe] — 27L d_model=2048 16H of latent attention (MLA:
kv_lora_rank 512, q/k heads 128 + 64 rotary, v heads 128, no query
compression), one dense SwiGLU layer (11,264) then 26 MoE layers of 64
routed experts (1,408 each, top-6 by a sigmoid router with a selection-only
bias, weights renormalised and scaled 2.446) and 2 shared experts;
vocab=163840, untied. [hf:moonshotai/Moonlight-16B-A3B]

A port-only architecture (the JAX package has none like it): training
through ``launch.steps.build_dds_train_step``; serving waits for a latent KV
cache. The published config sets no ``aux_loss_alpha``: the sequence-wise
balance loss is weighed 0.001 (assumed)."""
from .base import DeepseekV3Config

CONFIG = DeepseekV3Config(
    name="moonlight-16b-a3b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,
    d_ff=1408,
    vocab_size=163840,
    rope_theta=5e4,
    norm_eps=1e-5,
    num_experts=64,
    top_k=6,
    kv_lora_rank=512,
    qk_rope_dim=64,
    v_head_dim=128,
    first_dense_layers=1,
    dense_d_ff=11264,
    shared_experts=2,
    router="sigmoid",
    routed_scale=2.446,
    aux_weight=0.001,
    tie_embeddings=False,
    citation="[hf:moonshotai/Moonlight-16B-A3B]",
)
