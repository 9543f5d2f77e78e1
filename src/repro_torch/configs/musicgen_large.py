"""musicgen-large [audio] — decoder backbone over EnCodec tokens: 48L
d_model=2048 32H (kv=32) d_ff=8192 vocab=2048. [arXiv:2306.05284]

The EnCodec tokenizer / mel + conv frontend and the T5 text conditioner are
the sanctioned STUB: ``input_specs()`` supplies conditioning frame embeddings
as prefix embeddings; the decoder operates on one interleaved codebook
stream (delay-pattern flattening happens in the stub). Positional encoding is
rotary here (framework standard) vs. the original's learned sinusoidal —
recorded in DESIGN.md."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    embed_input=True,
    frontend_tokens=64,    # conditioning frames from the stub frontend
    rope_theta=1e4,
    citation="[arXiv:2306.05284]",
)
