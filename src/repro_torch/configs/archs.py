"""Architectures the port runs (the dense subset of ``repro/configs/archs.py``).

``reduced`` mirrors the JAX package's smoke variant for the dense family:
one layer per distinct slot, d_model 64, at most 4 heads, d_ff 2·d,
vocab 256.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, AttnCfg, Group, LayerCfg, \
    uniform_dense

QWEN15_05B = uniform_dense(
    "qwen1.5-0.5b", n_layers=24, d_model=1024, n_heads=16, n_kv=16,
    d_ff=2816, vocab=151_936, qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6,
    source="[hf:Qwen/Qwen1.5-0.5B] 24L d1024 16H(kv16) ff2816 v151936, QKV bias")

REGISTRY: dict[str, ArchConfig] = {c.name: c for c in [QWEN15_05B]}


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch '{name}' (have {sorted(REGISTRY)})")
    return REGISTRY[name]


def _shrink_attn(a: AttnCfg, d: int) -> AttnCfg:
    h = max(2, min(a.n_heads, 4))
    kv = 1 if a.n_kv_heads < a.n_heads else h
    return AttnCfg(h, kv, max(8, d // h), a.qkv_bias)


def reduced(cfg: ArchConfig, d_model: int = 64, max_slots: int = 2) -> ArchConfig:
    """≤2-layer, tiny-width smoke variant with the same layer types."""
    slots = [s for g in cfg.groups for s in g.slots]
    if len(slots) > max_slots:
        seen: dict[tuple, LayerCfg] = {}
        for s in slots:
            seen.setdefault((s.mixer, s.ffn), s)
        slots = list(seen.values())[:max_slots]
    slots = [LayerCfg(mixer=s.mixer, attn=_shrink_attn(s.attn, d_model),
                      ffn=s.ffn, d_ff=2 * d_model) for s in slots]
    return dataclasses.replace(
        cfg, name=cfg.name + "-reduced", d_model=d_model, vocab=256,
        groups=(Group(tuple(slots), 1),), max_seq=128)
