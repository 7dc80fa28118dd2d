"""Checkpointing: a flattened tree in an ``.npz`` plus JSON metadata (the
port of ``repro/checkpoint/ckpt.py``, in numpy and torch only).

The file layout is the JAX package's, so either package reads the other's
checkpoints:

* every leaf is stored under its '/'-joined path (nested dict keys, list
  indices) in one ``.npz``;
* a bfloat16 leaf, which npz cannot hold, is stored as its uint16 bits
  under ``<path>::bf16``;
* the metadata is ``<path>.meta.json`` beside the ``.npz``.

Leaves may be torch tensors (copied to the host) or numpy arrays.  ``load``
returns numpy arrays exactly as saved (int64 and float64 included: flood
state keeps message coefficients and bitsets there), bf16 leaves as
bfloat16 tensors, nested by path.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.models import params as plib

BF16_SUFFIX = "::bf16"


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _meta_path(path: str) -> str:
    """Where the metadata of ``path`` lives: the JAX package looks for
    ``<stem>.meta.json`` first, then ``<path>.meta.json``."""
    stem = path[:-4] if path.endswith(".npz") else path
    if os.path.exists(stem + ".meta.json"):
        return stem + ".meta.json"
    return path + ".meta.json"


def save(path: str, tree: Any, metadata: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    for k, v in _flatten(tree).items():
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if v.dtype == torch.bfloat16:
                arrays[k + BF16_SUFFIX] = v.view(torch.int16).cpu().numpy() \
                    .view(np.uint16)
                continue
            v = v.cpu().numpy()
        arrays[k] = np.asarray(v)
    np.savez(path, **arrays)
    with open(path + ".meta.json", "w") as f:
        json.dump(metadata or {}, f, indent=2, default=str)


def load(path: str, like: Any | None = None) -> tuple[Any, dict]:
    """Restore a checkpoint tree and its JSON metadata.  With ``like`` (a
    reference tree), a checkpoint whose paths differ is refused, naming the
    missing and extra keys, and each leaf takes ``like``'s dtype, shape and
    (for a tensor) device."""
    npz = path if path.endswith(".npz") else path + ".npz"
    flat: dict[str, Any] = {}
    with np.load(npz) as z:
        for k in z.files:
            if k.endswith(BF16_SUFFIX):
                bits = torch.from_numpy(z[k].view(np.int16).copy())
                flat[k[:-len(BF16_SUFFIX)]] = bits.view(torch.bfloat16)
            else:
                flat[k] = z[k]
    meta = {}
    meta_path = _meta_path(path)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    if like is not None:
        ref = _flatten(like)
        missing, extra = set(ref) - set(flat), set(flat) - set(ref)
        if missing or extra:
            raise ValueError(f"checkpoint mismatch: missing="
                             f"{sorted(missing)[:5]} extra={sorted(extra)[:5]}")
        flat = {k: _like(r, flat[k]) for k, r in ref.items()}
    return plib.nest(flat), meta


def _like(ref, got):
    if isinstance(ref, torch.Tensor):
        return torch.as_tensor(got).to(ref.dtype).reshape(ref.shape).to(
            ref.device)
    ref = np.asarray(ref)
    return np.asarray(got, ref.dtype).reshape(ref.shape)
