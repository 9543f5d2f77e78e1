"""The four input shapes of the dry run, the per-architecture federation
layouts, and the input specs of each step, as ``meta`` tensors.

Counterpart of ``repro.launch.shapes``. Where the reference returns
``jax.ShapeDtypeStruct``s, the port returns tensors on the ``meta`` device:
shapes and dtypes, no storage — nothing here allocates. The port keeps its
own copies of the tables (``INPUT_SHAPES``, ``FED_LAYOUT``).

One deliberate difference: ``train_input_specs`` has no ``rng``. The
reference's round splits one per vehicle and uses none of it (no dropout),
so the port's step takes none (``launch/steps.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..configs.base import ArchConfig
from ..configs.registry import ARCHITECTURES

META = torch.device("meta")


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# Federation layout: (vehicle, fsdp) factors of the 16-wide data axis, chosen
# by the reference so that parameters, AdamW moments and gradients fit its
# device memory at f32.
FED_LAYOUT: dict[str, tuple[int, int]] = {
    "qwen1.5-4b": (16, 1),
    "qwen2.5-3b": (16, 1),
    "hymba-1.5b": (16, 1),
    "internvl2-26b": (4, 4),
    "qwen3-1.7b": (16, 1),
    "musicgen-large": (16, 1),
    "granite-moe-1b-a400m": (16, 1),
    "granite-34b": (2, 8),
    "rwkv6-3b": (16, 1),
    "mixtral-8x7b": (2, 8),
}

# long_500k window for archs with neither sub-quadratic mixing nor native SWA
LONG_CONTEXT_WINDOW = 8_192


def is_subquadratic(cfg: ArchConfig) -> bool:
    return cfg.attn_free or cfg.hybrid or cfg.sliding_window is not None


def long_context_cfg(cfg: ArchConfig) -> ArchConfig:
    """Config variant used for long_500k: native for SSM/hybrid/SWA archs,
    sliding-window (8192) retrofit for pure full-attention archs."""
    if is_subquadratic(cfg):
        return cfg
    return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)


def serve_cfg(cfg: ArchConfig, model_shards: int = 16) -> ArchConfig:
    """Serving config: mesh padding + kv-head padding for cache sharding when
    the kv count is at least half the model-parallel degree (<=2x waste)."""
    c = cfg.pad_for_mesh(model_shards)
    if (not c.attn_free and c.num_kv_heads % model_shards
            and c.num_kv_heads >= model_shards // 2):
        nkv = ((c.num_kv_heads + model_shards - 1) // model_shards) * model_shards
        nh = c.num_heads
        if nh % nkv:
            nh = ((nh + nkv - 1) // nkv) * nkv
        c = dataclasses.replace(c, num_kv_heads=nkv, num_heads=max(nh, c.num_heads),
                                true_num_kv_heads=c.true_num_kv_heads,
                                true_num_heads=c.true_num_heads)
    return c


def text_seq_len(cfg: ArchConfig, shape: InputShape) -> int:
    """Token positions = seq_len minus the stub-frontend prefix positions."""
    if cfg.embed_input and shape.kind in ("train", "prefill"):
        return shape.seq_len - cfg.frontend_tokens
    return shape.seq_len


def _meta(*shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


# ------------------------------------------------------------ input specs ---

def train_input_specs(cfg: ArchConfig, shape: InputShape, num_vehicles: int) -> dict:
    """Meta tensors for one DFL-DDS training round (stacked over V)."""
    assert shape.kind == "train"
    v = num_vehicles
    per_vehicle = shape.global_batch // v
    s = text_seq_len(cfg, shape)
    specs = {
        "tokens": _meta(v, per_vehicle, s, dtype=torch.int32),
        "contact": _meta(v, v),
        "target": _meta(v),
    }
    if cfg.embed_input:
        specs["prefix_embeds"] = _meta(v, per_vehicle, cfg.frontend_tokens, cfg.d_model)
    return specs


def prefill_input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    assert shape.kind == "prefill"
    s = text_seq_len(cfg, shape)
    specs = {"tokens": _meta(shape.global_batch, s, dtype=torch.int32)}
    if cfg.embed_input:
        specs["prefix_embeds"] = _meta(shape.global_batch, cfg.frontend_tokens, cfg.d_model)
    return specs


def decode_input_specs(cfg: ArchConfig, shape: InputShape,
                       cache_dtype=torch.bfloat16) -> dict:
    """Token + DecodeState meta tensors for one decode step at cache length
    ``shape.seq_len``."""
    assert shape.kind == "decode"
    from ..models import transformer

    b = shape.global_batch
    state = transformer.init_decode_state(cfg, b, shape.seq_len, cache_dtype, device=META)
    return {"tokens": _meta(b, 1, dtype=torch.int32), "state": state}


def arch_ids() -> list[str]:
    return list(ARCHITECTURES)
