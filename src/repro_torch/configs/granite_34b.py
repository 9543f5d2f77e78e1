"""granite-34b [dense] — 88L d_model=6144 48H (GQA kv=1, i.e. MQA)
d_ff=24576 vocab=49152 — code model, llama-style blocks. [arXiv:2405.04324]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=1e4,
    citation="[arXiv:2405.04324]",
)
