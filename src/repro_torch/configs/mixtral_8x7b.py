"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 (per
expert) vocab=32000, 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1e6,
    citation="[arXiv:2401.04088]",
)
