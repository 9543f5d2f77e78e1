"""Checkpointing of trees of tensors (npz-based).

Counterpart of ``repro.checkpoint.checkpoint``, in the same file layout: a
tree (nested dictionaries, lists, tuples and named tuples of tensors, numpy
arrays or numbers) is flattened by key path — dictionary keys, ``#<index>``
for sequence positions, field names for named tuples, joined by ``/`` — into
one ``.npz`` archive, with the tree's structure under ``__treedef__`` and
optional JSON metadata under ``__meta__``. A checkpoint written by either
package restores in the other. Writes are atomic (write to a temporary file
beside the target, then rename), and ``CheckpointManager`` keeps
step-numbered checkpoints with retention.

bf16 tensors are stored as f32 (numpy has no bf16) and cast back on restore.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

Tree = Any

_SEP = "/"


def _path_str(p) -> str:
    if hasattr(p, "key"):
        return str(p.key)
    if hasattr(p, "idx"):
        return f"#{p.idx}"
    if hasattr(p, "name"):
        return str(p.name)
    return str(p)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Tree) -> dict[str, Any]:
    """Leaves of ``tree`` by their ``/``-joined key path."""
    flat = {}
    for path, leaf in pytree.tree_flatten_with_path(tree)[0]:
        flat[_SEP.join(_path_str(p) for p in path)] = leaf
    return flat


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, tree: Tree, metadata: dict | None = None) -> None:
    """Save a tree to ``path`` (.npz appended if missing). Atomic."""
    path = _npz_path(path)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    payload = {key: _to_numpy(leaf) for key, leaf in _flatten(tree).items()}
    payload["__treedef__"] = np.frombuffer(
        json.dumps(str(pytree.tree_structure(tree))).encode(), dtype=np.uint8)
    if metadata:
        payload["__meta__"] = np.frombuffer(json.dumps(metadata).encode(),
                                            dtype=np.uint8)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def restore(path: str, like: Tree) -> Tree:
    """Restore into the structure of ``like``: shapes are checked, and each
    leaf takes the dtype of ``like``'s leaf (and, for a tensor, its
    device)."""
    path = _npz_path(path)
    leaves_like, spec = pytree.tree_flatten(like)
    keys = list(_flatten(like))
    out = []
    with np.load(path) as data:
        for key, ref in zip(keys, leaves_like):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if arr.shape != tuple(np.shape(ref)):
                raise ValueError(
                    f"shape mismatch for {key}: {arr.shape} vs {tuple(np.shape(ref))}")
            if isinstance(ref, torch.Tensor):
                out.append(torch.as_tensor(arr).to(device=ref.device, dtype=ref.dtype))
            else:
                out.append(arr.astype(np.asarray(ref).dtype))
    return pytree.tree_unflatten(out, spec)


def metadata(path: str) -> dict:
    """The JSON metadata saved with a checkpoint ({} if none)."""
    with np.load(_npz_path(path)) as data:
        if "__meta__" not in data:
            return {}
        return json.loads(bytes(data["__meta__"].tobytes()).decode())


class CheckpointManager:
    """Step-numbered checkpoints with retention: <dir>/ckpt_<step>.npz."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _steps(self) -> list[int]:
        steps = []
        for f in os.listdir(self.directory):
            m = re.fullmatch(r"ckpt_(\d+)\.npz", f)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def save(self, step: int, tree: Tree, metadata: dict | None = None) -> str:
        meta = dict(metadata or {})
        meta["step"] = step
        path = os.path.join(self.directory, f"ckpt_{step}.npz")
        save(path, tree, meta)
        for old in self._steps()[: -self.keep] if self.keep else []:
            os.unlink(os.path.join(self.directory, f"ckpt_{old}.npz"))
        return path

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, like: Tree) -> tuple[Tree, int] | None:
        step = self.latest_step()
        if step is None:
            return None
        return restore(os.path.join(self.directory, f"ckpt_{step}.npz"), like), step
