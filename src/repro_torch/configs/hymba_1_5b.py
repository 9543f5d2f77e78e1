"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 — parallel attention + mamba heads in every block.
[arXiv:2411.13676]

Deviations noted in DESIGN.md: meta-tokens and cross-layer KV sharing of the
original are not modelled; the hybrid block here is the parallel
attn/SSM-branch average with per-branch normalization (the paper's core
topology)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    hybrid=True,
    rope_theta=1e4,
    citation="[arXiv:2411.13676]",
)
