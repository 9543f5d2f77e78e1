"""The paper's two CNNs (Sec. VI-A.2), parameter-count-exact.

* MNIST net  — 5x5 conv(10) / pool / 5x5 conv(20) / pool / FC(50) /
  dropout(0.5) / FC(10) / log-softmax             = 21,840 params
* CIFAR net  — 3x3 conv(16) / pool / 3x3 conv(32) / pool / 3x3 conv(64) /
  pool / dropout(0.25) / FC(10) / log-softmax     = 33,834 params

Counterpart of ``repro.models.cnn`` with the same parameter names and
layouts: NHWC inputs, HWIO conv weights, ``init(generator) -> params``
(dictionary), ``apply(params, x, ...) -> log_probs``.

The forward is written over **stacked** weights: every leaf may carry a
leading vehicle axis ``[K, ...]`` and the input a matching one
``[K, N, H, W, C]``; the convolution is im2col (``F.unfold``, which orders
patch features ``(cin, kh, kw)`` like the reference's
``conv_general_dilated_patches``) followed by one batched matrix product
over the K weight sets — no Python loop over vehicles and no cuDNN
convolution (which would run f32 in TF32 by default). Unstacked weights with
an ``[N, H, W, C]`` input are the K = 1 case.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.vehicle_axis import RowBlockGenerator

Tensor = torch.Tensor


def _conv(x: Tensor, w: Tensor, b: Tensor, k: int, padding: str) -> Tensor:
    """Stacked convolution as im2col + batched matmul.

    x ``[K*N, cin, H, W]`` (vehicle-major), w ``[K, kh, kw, cin, cout]``,
    b ``[K, cout]`` -> ``[K*N, cout, H', W']``.
    """
    _, kh, kw, cin, cout = w.shape
    pad = (kh // 2, kw // 2) if padding == "SAME" else (0, 0)
    h_out = x.shape[2] + 2 * pad[0] - kh + 1
    w_out = x.shape[3] + 2 * pad[1] - kw + 1
    n = x.shape[0] // k
    feat = cin * kh * kw
    # F.unfold launches one im2col kernel per batch element; folding the batch
    # into the channel axis makes it a single launch with the same
    # (sample, cin, kh, kw) feature order
    patches = F.unfold(x.reshape(1, k * n * cin, x.shape[2], x.shape[3]),
                       (kh, kw), padding=pad)            # [1, K*N*cin*kh*kw, L]
    patches = patches.reshape(k, n, feat, h_out * w_out).permute(0, 1, 3, 2)
    patches = patches.reshape(k, n * h_out * w_out, feat)
    # unfold orders features as (cin, kh, kw)
    wmat = w.permute(0, 3, 1, 2, 4).reshape(k, feat, cout)
    out = torch.bmm(patches, wmat) + b[:, None, :]       # [K, N*L, cout]
    return out.reshape(k * n, h_out, w_out, cout).permute(0, 3, 1, 2)


def _maxpool2(x: Tensor) -> Tensor:
    return F.max_pool2d(x, 2, 2)


def _glorot(generator, shape) -> Tensor:
    fan_in = math.prod(shape[:-1])
    fan_out = shape[-1]
    scale = math.sqrt(2.0 / (fan_in + fan_out))
    return scale * torch.randn(shape, generator=generator, dtype=torch.float32)


def _dropout(x: Tensor, rate: float, mask: Tensor | None, generator,
             train: bool) -> Tensor:
    """Inverted dropout. ``mask`` (1 = keep, shaped like ``x``) is used as
    given; otherwise a keep mask is drawn from ``generator``. With neither,
    or ``train=False``, the input passes through.

    ``generator`` may be a tuple of S generators, one per seed of a
    seed-stacked batch (``x``'s leading axis seed-major): each draws the mask
    of its own equal share of the rows, as a single run of that seed would.
    It may be a ``RowBlockGenerator`` (one shard of a vehicle-sharded run):
    the mask is drawn for every shard's rows and this shard keeps its block,
    as the global run draws it.
    """
    if not train or rate <= 0.0 or (mask is None and generator is None):
        return x
    if mask is None and isinstance(generator, RowBlockGenerator):
        mask = generator.rand_rows(x.shape, x.device) >= rate
    elif mask is None and isinstance(generator, tuple):
        share = (x.shape[0] // len(generator),) + tuple(x.shape[1:])
        mask = torch.cat([torch.rand(share, generator=g, device=x.device)
                          for g in generator]) >= rate
    elif mask is None:
        mask = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(mask.to(torch.bool), x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _stacked(params: dict, x: Tensor):
    """Lift unstacked params / an [N, H, W, C] input to the K = 1 stacked form."""
    single = params["conv1_w"].dim() == 4
    if single:
        params = {name: p[None] for name, p in params.items()}
        x = x[None]
    if x.dim() != 5:
        raise ValueError(f"input of shape {tuple(x.shape)} does not match "
                         f"{'un' if single else ''}stacked parameters")
    k = params["conv1_w"].shape[0]
    if x.shape[0] != k:
        raise ValueError(f"input carries {x.shape[0]} vehicles, params {k}")
    return params, x, k, single


def _to_nchw(x: Tensor) -> Tensor:
    """[K, N, H, W, C] -> [K*N, C, H, W]."""
    k, n, h, w, c = x.shape
    return x.reshape(k * n, h, w, c).permute(0, 3, 1, 2)


def _flatten_nhwc(x: Tensor, k: int) -> Tensor:
    """[K*N, C, H, W] -> [K, N, H*W*C] (the reference flattens NHWC)."""
    return x.permute(0, 2, 3, 1).reshape(k, x.shape[0] // k, -1)


# ----------------------------------------------------------------- MNIST ----

def mnist_cnn_init(generator=None) -> dict:
    return {
        "conv1_w": _glorot(generator, (5, 5, 1, 10)), "conv1_b": torch.zeros(10),
        "conv2_w": _glorot(generator, (5, 5, 10, 20)), "conv2_b": torch.zeros(20),
        "fc1_w": _glorot(generator, (320, 50)), "fc1_b": torch.zeros(50),
        "fc2_w": _glorot(generator, (50, 10)), "fc2_b": torch.zeros(10),
    }


def mnist_cnn_apply(params: dict, x: Tensor, dropout_mask: Tensor | None = None,
                    generator=None, train: bool = False) -> Tensor:
    """``x`` [N, 28, 28, 1] with unstacked params, or [K, N, 28, 28, 1] with
    ``[K, ...]`` params; returns log-probabilities ``[(K,) N, 10]``."""
    params, x, k, single = _stacked(params, x)
    h = _to_nchw(x)
    h = torch.relu(_maxpool2(_conv(h, params["conv1_w"], params["conv1_b"], k, "VALID")))
    h = torch.relu(_maxpool2(_conv(h, params["conv2_w"], params["conv2_b"], k, "VALID")))
    h = _flatten_nhwc(h, k)
    h = torch.relu(torch.bmm(h, params["fc1_w"]) + params["fc1_b"][:, None, :])
    h = _dropout(h, 0.5, dropout_mask, generator, train)
    logits = torch.bmm(h, params["fc2_w"]) + params["fc2_b"][:, None, :]
    out = torch.log_softmax(logits, dim=-1)
    return out[0] if single else out


# ----------------------------------------------------------------- CIFAR ----

def cifar_cnn_init(generator=None) -> dict:
    return {
        "conv1_w": _glorot(generator, (3, 3, 3, 16)), "conv1_b": torch.zeros(16),
        "conv2_w": _glorot(generator, (3, 3, 16, 32)), "conv2_b": torch.zeros(32),
        "conv3_w": _glorot(generator, (3, 3, 32, 64)), "conv3_b": torch.zeros(64),
        "fc_w": _glorot(generator, (1024, 10)), "fc_b": torch.zeros(10),
    }


def cifar_cnn_apply(params: dict, x: Tensor, dropout_mask: Tensor | None = None,
                    generator=None, train: bool = False) -> Tensor:
    """``x`` [N, 32, 32, 3] or [K, N, 32, 32, 3]; see ``mnist_cnn_apply``.
    The dropout mask, when given, is shaped like the pooled NCHW activations
    ``[K*N, 64, 4, 4]``."""
    params, x, k, single = _stacked(params, x)
    h = _to_nchw(x)
    h = torch.relu(_maxpool2(_conv(h, params["conv1_w"], params["conv1_b"], k, "SAME")))
    h = torch.relu(_maxpool2(_conv(h, params["conv2_w"], params["conv2_b"], k, "SAME")))
    h = torch.relu(_maxpool2(_conv(h, params["conv3_w"], params["conv3_b"], k, "SAME")))
    h = _dropout(h, 0.25, dropout_mask, generator, train)
    h = _flatten_nhwc(h, k)
    logits = torch.bmm(h, params["fc_w"]) + params["fc_b"][:, None, :]
    out = torch.log_softmax(logits, dim=-1)
    return out[0] if single else out


# ------------------------------------------------------------- task glue ----

def nll_loss(log_probs: Tensor, labels: Tensor) -> Tensor:
    """Mean negative log-likelihood over the sample axis: a scalar for
    ``[N, C]`` log-probs, ``[K]`` per-vehicle losses for ``[K, N, C]``."""
    picked = torch.take_along_dim(log_probs, labels.long().unsqueeze(-1), dim=-1)
    return -torch.mean(picked.squeeze(-1), dim=-1)


def make_cnn_task(kind: str):
    """Returns (init_fn, loss_fn, accuracy_fn) for 'mnist' or 'cifar10'.

    ``loss_fn(params, x, y, generator)`` trains with dropout drawn from
    ``generator`` (none when it is None); ``accuracy_fn(params, x, y)``
    evaluates. Both follow the stacking of ``params`` (see module docstring).
    """
    if kind in ("mnist", "synthetic-mnist"):
        init_fn, apply_fn = mnist_cnn_init, mnist_cnn_apply
    elif kind in ("cifar10", "synthetic-cifar10"):
        init_fn, apply_fn = cifar_cnn_init, cifar_cnn_apply
    else:
        raise ValueError(kind)

    def loss_fn(params, x, y, generator=None):
        return nll_loss(apply_fn(params, x, generator=generator, train=True), y)

    @torch.no_grad()
    def accuracy_fn(params, x, y):
        pred = torch.argmax(apply_fn(params, x), dim=-1)
        return torch.mean((pred == y).to(torch.float32), dim=-1)

    return init_fn, loss_fn, accuracy_fn


def count_params(params: dict) -> int:
    return sum(int(p.numel()) for p in params.values())
