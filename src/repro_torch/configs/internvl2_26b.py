"""internvl2-26b [vlm] — language backbone (InternLM2-20B shape): 48L
d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553. [arXiv:2404.16821]

The InternViT-6B vision encoder + MLP projector are the sanctioned STUB:
``input_specs()`` supplies precomputed patch embeddings (frontend_tokens
positions of d_model) that the decoder consumes as prefix embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    embed_input=True,
    frontend_tokens=256,   # one 448x448 tile -> 256 patch embeddings
    rope_theta=1e6,
    citation="[arXiv:2404.16821]",
)
