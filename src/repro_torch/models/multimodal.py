"""Modality frontend stubs of the [vlm] and [audio] architectures.

Counterpart of ``repro.models.multimodal``: the decoder is real and the
frontend (a ViT vision encoder, an EnCodec codec) is a stub that maps raw
inputs ``[B, frontend_tokens, F]`` to prefix embeddings ``[B,
frontend_tokens, d_model]`` through a fixed random projection and a tanh.

The projection ``w [F, d_model]`` is an argument. The reference draws it
from JAX's PRNG seeded by Python's ``hash(cfg.name)``, which is salted per
process: the port can reproduce neither, so a caller that needs the
reference's numbers passes its ``w`` in. Without one, ``w`` is drawn on the
CPU from a ``torch.Generator`` seeded by a stable digest of the name
(``zlib.crc32``) and moved to the input's device: the same ``w`` in every
process and on every device.
"""
from __future__ import annotations

import math
import zlib

import torch

from ..configs.base import ArchConfig

Tensor = torch.Tensor


def frontend_feature_dim(cfg: ArchConfig) -> int:
    """Feature dim of the raw frontend input the stub consumes."""
    if cfg.family == "vlm":
        return 14 * 14 * 3      # one ViT patch of pixels
    if cfg.family == "audio":
        return 128              # mel bins per frame
    raise ValueError(f"{cfg.name} has no frontend")


def frontend_projection(cfg: ArchConfig, device=None) -> Tensor:
    """The stub's default ``[F, d_model]`` projection, seeded by the name."""
    gen = torch.Generator().manual_seed(zlib.crc32(cfg.name.encode()))
    w = torch.randn((frontend_feature_dim(cfg), cfg.d_model), generator=gen,
                    dtype=torch.float32)
    return w.to(device)


def frontend_embeddings(cfg: ArchConfig, raw: Tensor, w: Tensor | None = None) -> Tensor:
    """Map raw frontend inputs ``[B, frontend_tokens, F]`` to ``[B,
    frontend_tokens, d_model]`` embeddings: ``tanh(raw @ (w / sqrt(F)))``."""
    _, t, f = raw.shape
    if t != cfg.frontend_tokens:
        raise ValueError(f"{cfg.name}: {t} frontend positions, the config has "
                         f"{cfg.frontend_tokens}")
    if w is None:
        w = frontend_projection(cfg, raw.device)
    return torch.tanh(raw.to(torch.float32) @ (w / math.sqrt(f)))
