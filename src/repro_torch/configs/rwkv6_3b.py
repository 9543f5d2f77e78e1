"""rwkv6-3b [ssm] — "Finch": 32L d_model=2560 (attention-free, 40 wkv heads of
64) d_ff=8960 vocab=65536 — data-dependent decay. [arXiv:2404.05892]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,         # wkv heads (d_model / head_dim; padded 40->48 at 16-way TP)
    num_kv_heads=0,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    attn_free=True,
    norm_eps=1e-5,
    citation="[arXiv:2404.05892]",
)
