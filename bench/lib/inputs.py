"""Inputs the benchmark makes from ``--seed`` and hands to both the program
and the reference: synthetic MNIST, the CNN's initial weights, granite's
initial weights and its token batches. Each is made on the run's device with
a seeded ``torch.Generator`` in a few large calls, so a seed gives the same
inputs on every run.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


def generator(device, seed: int, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``(seed, stream)``: each stream of a run
    draws apart from the others."""
    mixed = np.random.SeedSequence([int(seed) % (1 << 63), stream]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed) & ((1 << 63) - 1))


@dataclass
class Dataset:
    """A dataset as the program's federation takes it: numpy arrays, NHWC
    images in [0, 1], int32 labels."""
    train_x: np.ndarray
    train_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    num_classes: int = 10
    name: str = "synthetic-mnist"


def synthetic_mnist(device, seed: int, n_train: int = 60_000, n_test: int = 10_000) -> Dataset:
    """Procedural MNIST stand-in (60,000 / 10,000 of 28 x 28 x 1, ten
    classes): per class a smooth pattern (a 7 x 7 normal grid, bilinearly
    upsampled), per sample a circular shift of up to 3 pixels each way, a
    contrast gain of 1 + 0.25 N(0, 1), noise 0.35 N(0, 1), then a sigmoid."""
    g = generator(device, seed, stream=1)
    lo = torch.randn((10, 1, 7, 7), generator=g, device=device)
    protos = F.interpolate(lo, size=(28, 28), mode="bilinear", align_corners=True)[:, 0]

    def render(n):
        y = torch.randint(0, 10, (n,), generator=g, device=device)
        dy = torch.randint(-3, 4, (n,), generator=g, device=device)
        dx = torch.randint(-3, 4, (n,), generator=g, device=device)
        ar = torch.arange(28, device=device)
        rows = (ar[None, :] - dy[:, None]) % 28
        cols = (ar[None, :] - dx[:, None]) % 28
        img = protos[y[:, None, None], rows[:, :, None], cols[:, None, :]]
        gain = 1.0 + 0.25 * torch.randn((n, 1, 1), generator=g, device=device)
        img = img * gain + 0.35 * torch.randn((n, 28, 28), generator=g, device=device)
        return torch.sigmoid(img)[..., None], y

    tx, ty = render(n_train)
    vx, vy = render(n_test)
    return Dataset(tx.cpu().numpy(), ty.to(torch.int32).cpu().numpy(),
                   vx.cpu().numpy(), vy.to(torch.int32).cpu().numpy())


CNN_LEAVES = (("conv1", (5, 5, 1, 10)), ("conv2", (5, 5, 10, 20)),
              ("fc1", (320, 50)), ("fc2", (50, 10)))


def cnn_init(device, seed: int) -> dict:
    """One vehicle's MNIST CNN weights (HWIO): Glorot normal, zero biases,
    all weights from one draw."""
    g = generator(device, seed, stream=2)
    sizes = [math.prod(s) for _, s in CNN_LEAVES]
    flat = torch.randn((sum(sizes),), generator=g, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(CNN_LEAVES, sizes):
        scale = math.sqrt(2.0 / (math.prod(shape[:-1]) + shape[-1]))
        out[f"{name}_w"] = scale * flat[at:at + n].reshape(shape)
        out[f"{name}_b"] = torch.zeros(shape[-1], device=device)
        at += n
    return out


def granite_leaves(cfg: dict) -> list[tuple[str, tuple, float | None]]:
    """Granite's leaves as ``(path, shape, std)``: std None is a norm weight
    (ones). Per-layer leaves are stacked on a leading ``[L]`` axis."""
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    h, kv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    e, f, v = cfg["num_local_experts"], cfg["intermediate_size"], cfg["vocab_size"]
    return [("embed", (v, d), 0.02),
            ("blocks/norm1", (L, d), None), ("blocks/norm2", (L, d), None),
            ("blocks/attn/wq", (L, d, h * hd), d ** -0.5),
            ("blocks/attn/wk", (L, d, kv * hd), d ** -0.5),
            ("blocks/attn/wv", (L, d, kv * hd), d ** -0.5),
            ("blocks/attn/wo", (L, h * hd, d), (h * hd) ** -0.5),
            ("blocks/moe/router", (L, d, e), d ** -0.5),
            ("blocks/moe/w_gate", (L, e, d, f), d ** -0.5),
            ("blocks/moe/w_up", (L, e, d, f), d ** -0.5),
            ("blocks/moe/w_down", (L, e, f, d), f ** -0.5),
            ("final_norm", (d,), None)]


def granite_leaf(cfg: dict, seed: int, index: int, device, out: torch.Tensor | None = None):
    """Leaf ``index`` of ``granite_leaves`` drawn from ``(seed, index)``:
    one call, written into ``out`` when given. Regenerable on its own."""
    path, shape, std = granite_leaves(cfg)[index]
    if out is None:
        out = torch.empty(shape, device=device)
    if std is None:
        return out.fill_(1.0)
    g = generator(device, seed, stream=100 + index)
    torch.randn(shape, generator=g, device=device, out=out)
    return out.mul_(std)


def granite_tokens(cfg: dict, seed: int, round_index: int, vehicles: int, batch: int,
                   seq: int, device) -> torch.Tensor:
    """Round ``round_index``'s ``[V, B, S]`` token ids, uniform over the
    vocabulary."""
    g = generator(device, seed, stream=10_000 + round_index)
    return torch.randint(0, cfg["vocab_size"], (vehicles, batch, seq), generator=g,
                         device=device)
