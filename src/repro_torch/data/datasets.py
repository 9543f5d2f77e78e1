"""Dataset loaders: real MNIST/CIFAR-10 files when present, synthetic fallback.

Set ``REPRO_DATA_DIR`` to a directory containing the standard files:
  MNIST:    train-images-idx3-ubyte, train-labels-idx1-ubyte,
            t10k-images-idx3-ubyte, t10k-labels-idx1-ubyte  (optionally .gz)
  CIFAR-10: data_batch_1..5, test_batch (python pickle format)
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

from .synthetic import Dataset, synthetic_cifar10, synthetic_mnist


def _open_maybe_gz(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def _read_idx(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def load_mnist(data_dir: str | None = None, seed: int = 0) -> Dataset:
    data_dir = data_dir or os.environ.get("REPRO_DATA_DIR", "")
    try:
        tx = _read_idx(os.path.join(data_dir, "train-images-idx3-ubyte"))
        ty = _read_idx(os.path.join(data_dir, "train-labels-idx1-ubyte"))
        vx = _read_idx(os.path.join(data_dir, "t10k-images-idx3-ubyte"))
        vy = _read_idx(os.path.join(data_dir, "t10k-labels-idx1-ubyte"))
        return Dataset(
            train_x=(tx[..., None] / 255.0).astype(np.float32), train_y=ty.astype(np.int32),
            test_x=(vx[..., None] / 255.0).astype(np.float32), test_y=vy.astype(np.int32),
            num_classes=10, name="mnist",
        )
    except (FileNotFoundError, OSError):
        return synthetic_mnist(seed=seed)


def load_cifar10(data_dir: str | None = None, seed: int = 1) -> Dataset:
    data_dir = data_dir or os.environ.get("REPRO_DATA_DIR", "")
    try:
        def batch(name):
            with open(os.path.join(data_dir, name), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            return (x / 255.0).astype(np.float32), np.array(d[b"labels"], np.int32)

        xs, ys = zip(*[batch(f"data_batch_{i}") for i in range(1, 6)])
        vx, vy = batch("test_batch")
        return Dataset(
            train_x=np.concatenate(xs), train_y=np.concatenate(ys),
            test_x=vx, test_y=vy, num_classes=10, name="cifar10",
        )
    except (FileNotFoundError, OSError):
        return synthetic_cifar10(seed=seed)


def load_dataset(name: str, seed: int = 0) -> Dataset:
    if name in ("mnist", "synthetic-mnist"):
        return load_mnist(seed=seed)
    if name in ("cifar10", "synthetic-cifar10"):
        return load_cifar10(seed=seed)
    raise ValueError(f"unknown dataset {name!r}")
