"""LoRA adapters for the communication-efficient FO/ZO baselines (the port
of ``repro/dtrain/lora.py``; paper §4.2: DSGD-LoRA / ChocoSGD-LoRA /
DZSGD-LoRA; App. B.3: r = 8, α = 16, q_proj + v_proj targets).

Adapters are a flat dict ``{leaf_path + "/A": (…, n, r), leaf_path + "/B":
(…, r, m)}``; ``merge`` materializes W + (α/r)·A@B for the adapted leaves
(the baselines gossip only the adapter dict, which is what their ledger
charges).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import params as plib
from repro_torch.models.params import LeafSpec


DEFAULT_TARGETS = ("wq", "wv")


def lora_spec(spec: dict[str, LeafSpec], targets=DEFAULT_TARGETS,
              r: int = 8) -> dict[str, LeafSpec]:
    """A (scale 0.01) and B (zeros) for every 2D target leaf."""
    out: dict[str, LeafSpec] = {}
    for path, leaf in spec.items():
        name = path.split("/")[-1]
        if name not in targets or len(leaf.shape) - leaf.n_batch_dims != 2:
            continue
        batch = leaf.shape[:leaf.n_batch_dims]
        n, m = leaf.shape[-2], leaf.shape[-1]
        out[path + "/A"] = LeafSpec(batch + (n, r), leaf.n_batch_dims,
                                    scale=0.01)
        out[path + "/B"] = LeafSpec(batch + (r, m), leaf.n_batch_dims,
                                    init="zeros")
    return out


def lora_init(lspec: dict[str, LeafSpec], seed: int = 0,
              device="cpu") -> dict:
    return plib.init_params(lspec, seed, device)


def merge(params: dict, lora: dict, alpha: float = 16.0) -> dict:
    """W_eff = W + (α/r)·A@B for every adapted leaf; the other leaves are
    the same tensors.  Works on any leading axes (clients, layers)."""
    out = dict(params)
    for path in sorted({p.rsplit("/", 1)[0] for p in lora}):
        A, B = lora[path + "/A"], lora[path + "/B"]
        r = A.shape[-1]
        out[path] = params[path] + ((alpha / r) * torch.matmul(A, B)).to(
            params[path].dtype)
    return out


def n_lora_params(lspec: dict[str, LeafSpec]) -> int:
    """Floats in the adapters of ``lspec`` (what a LoRA gossip sends)."""
    return sum(int(math.prod(s.shape)) for s in lspec.values())
