"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936 — per-head q/k RMSNorm (qk_norm), no QKV bias.
[hf:Qwen/Qwen3-8B family card]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    citation="[hf:Qwen/Qwen3-8B]",
)
