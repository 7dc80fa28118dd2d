"""Layers of the dense decoder, perturbation-aware (the dense subset of
``repro/models/layers.py``).

Activations carry a leading client axis: ``x (C, B, T, D)``.  Attention is
plain PyTorch, as the JAX package computes it outside any Pallas kernel;
the perturbed projections go through ``Bundle.dense`` (the fused kernels).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttnCfg
from repro_torch.models.perturb import Bundle

_NEG_INF = -1e30


def _per_client(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(C, D) -> broadcastable against a (C, ..., D) activation."""
    return v.reshape((v.shape[0],) + (1,) * (ndim - 2) + (v.shape[-1],))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """f32 variance statistic; the normalizing multiply stays in x.dtype.
    ``scale`` is per client (C, D)."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + _per_client(scale, x.ndim).to(x.dtype))


def norm(b: Bundle, key: str, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(x, b.vec(key + "_scale"))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding.  x (..., T, H, hd), positions (T,)."""
    hd = x.shape[-1]
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=x.device), exps)
    ang = positions.float()[..., None] * freqs              # (T, hd/2)
    cos = torch.cos(ang)[..., None, :]                      # (T, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """(T, S) boolean causal mask (k_pos = -1 marks an empty slot)."""
    return (k_pos[None, :] <= q_pos[:, None]) & (k_pos[None, :] >= 0)


def attn_core(q, k, v, q_pos, k_pos):
    """Grouped-query attention.  q (C,B,T,H,hd), k/v (C,B,S,KV,hd)
    -> (C,B,T,H*hd)."""
    C, B, T, H, hd = q.shape
    KV = k.shape[3]
    G = H // KV
    qg = q.reshape(C, B, T, KV, G, hd)
    logits = torch.einsum("cbtkgd,cbskd->cbkgts", qg, k).float()
    logits = logits * (1.0 / math.sqrt(hd))
    mask = attn_mask(q_pos, k_pos)
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("cbkgts,cbskd->cbtkgd", probs, v)
    return out.reshape(C, B, T, H * hd)


def attention(b: Bundle, x: torch.Tensor, acfg: AttnCfg, rope_theta: float):
    """Standard (GQA) attention without a cache (training forward)."""
    C, B, T, _ = x.shape
    H, KV, hd = acfg.n_heads, acfg.n_kv_heads, acfg.head_dim
    bias = acfg.qkv_bias
    q = b.dense("wq", x, bias="bq" if bias else None).reshape(C, B, T, H, hd)
    k = b.dense("wk", x, bias="bk" if bias else None).reshape(C, B, T, KV, hd)
    v = b.dense("wv", x, bias="bv" if bias else None).reshape(C, B, T, KV, hd)
    pos = torch.arange(T, device=x.device)
    q = rope(q, pos, rope_theta)
    k = rope(k, pos, rope_theta)
    out = attn_core(q, k, v, pos, pos)
    return b.dense("wo", out)


def mlp(b: Bundle, x: torch.Tensor) -> torch.Tensor:
    """Gated SiLU MLP."""
    h = F.silu(b.dense("w1", x)) * b.dense("w3", x)
    return b.dense("w2", h)
