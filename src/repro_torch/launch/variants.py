"""Variants of the step builders for performance work.

Counterpart of ``repro.launch.variants``. A variant maps (cfg, shape_kind)
-> (cfg', overrides of the step builder's keyword arguments); the baseline
is the paper-faithful configuration.

  flash        blocked online-softmax attention in plain torch
               (``models.attention.make_blocked_impl``)
  bf16         bf16 compute with f32 master parameters (train)
  gossip_bf16  bf16 gossip-mix payload, f32 accumulation (train;
               ``core.aggregation.mix_params_lowp``)
  ragged_moe   sorted / ragged MoE dispatch instead of dense-all-experts
  opt          every variant applicable to the arch and shape, combined as
               the reference combines them (train: bf16 + gossip_bf16)
  opt_ragged   bf16 + gossip_bf16 + ragged_moe
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from ..core import aggregation
from ..models.attention import make_blocked_impl

VARIANTS = ("baseline", "flash", "bf16", "gossip_bf16", "ragged_moe", "opt",
            "opt_ragged")


def apply_variant(name: str, cfg: ArchConfig, shape_kind: str):
    """Returns (cfg, overrides dict for the step builder). ``shape_kind`` is
    ``train``, ``prefill`` or ``decode``; a variant that does not apply to
    the arch and shape raises ``ValueError`` (``opt`` skips those parts)."""
    if name == "baseline":
        return cfg, {}
    overrides: dict = {}
    if name == "opt":
        parts = {"train": ["bf16", "gossip_bf16"], "prefill": [], "decode": []}[shape_kind]
    elif name == "opt_ragged":
        parts = ["bf16", "gossip_bf16", "ragged_moe"]
    else:
        parts = [name]
    for part in parts:
        if part == "flash" and not cfg.attn_free and shape_kind != "decode":
            overrides["attn_impl"] = make_blocked_impl(window=cfg.sliding_window)
        elif part == "bf16" and shape_kind == "train":
            overrides["compute_dtype"] = torch.bfloat16
        elif part == "gossip_bf16" and shape_kind == "train":
            overrides["mix_params_fn"] = aggregation.mix_params_lowp
        elif part == "ragged_moe" and cfg.is_moe:
            cfg = dataclasses.replace(cfg, moe_impl="ragged")
        elif name != "opt":
            raise ValueError(f"variant {part!r} not applicable to "
                             f"{cfg.name} x {shape_kind}")
    return cfg, overrides
