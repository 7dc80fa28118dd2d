"""Analytic FLOP / byte cost per (arch x input shape x step kind), and the
least time one NVIDIA H100 could take for it (the port of
``repro/roofline/cost_model.py``, whose arithmetic this copies in the same
order, so that the two packages' figures are equal by ``==``).

Conventions (the JAX package's):

* flops: 2·m·k·n per GEMM; attention 2·B·H·T·S·hd for scores and the same
  for values (causal self-attention halves S for train / prefill).
* bytes: every GEMM reads A, B and writes C once (perfect fusion of
  elementwise ops into their producers: the roofline-optimistic model),
  ``db`` bytes an element (2 for bf16, 4 for float32).
* ZO train: 2 forwards + the SubCGE update (U A V^T per matrix leaf, a
  dense Gaussian per message for the rest).  No backward.

The peaks replace the JAX package's TPU v5e figures with the H100 SXM's at
700 W (NVIDIA data sheet; the card the port runs on reports itself as
``NVIDIA H100 80GB HBM3, 700.00 W``): float32 on the CUDA cores, dense
bf16 on the tensor cores, HBM3 bandwidth.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ArchConfig, InputShape, LayerCfg

PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0

    def gemm(self, m: float, k: float, n: float, db: int = 2,
             batch: float = 1.0) -> None:
        self.flops += batch * 2.0 * m * k * n
        self.bytes += batch * db * (m * k + k * n + m * n)

    def ew(self, n_elems: float, flops_per: float = 1.0, db: int = 2,
           reads: int = 1, writes: int = 1) -> None:
        self.flops += n_elems * flops_per
        self.bytes += n_elems * db * (reads + writes)

    def add(self, other: "Cost", times: float = 1.0) -> None:
        self.flops += times * other.flops
        self.bytes += times * other.bytes


def bound_ms(cost: Cost, peak: float = PEAK_F32_FLOPS) -> float:
    """The least milliseconds one H100 takes for ``cost``: the larger of
    its bytes over the HBM rate and its operations over ``peak``."""
    return max(cost.bytes / PEAK_HBM_BYTES, cost.flops / peak) * 1e3


def _attn_cost(slot: LayerCfg, cfg: ArchConfig, B: float, T: float,
               S: float, causal: bool, db: int) -> Cost:
    c = Cost()
    a = slot.attn
    d = cfg.d_model
    if a.window is not None:
        S = min(S, a.window)
    s_eff = S * (0.5 if (causal and T > 1 and a.window is None) else 1.0)
    if a.is_mla:
        nope, rd = a.head_dim, a.rope_head_dim
        vd = a.v_head_dim or a.head_dim
        H = a.n_heads
        if a.q_lora:
            c.gemm(B * T, d, a.q_lora, db)
            c.gemm(B * T, a.q_lora, H * (nope + rd), db)
        else:
            c.gemm(B * T, d, H * (nope + rd), db)
        c.gemm(B * T, d, a.kv_lora + rd, db)
        if T == 1:  # absorbed decode
            c.gemm(B * H, nope, a.kv_lora, db)                 # q absorption
            c.gemm(B * H * T, a.kv_lora + rd, s_eff, db)       # scores
            c.gemm(B * H * T, s_eff, a.kv_lora, db)            # values
            c.gemm(B * H * T, a.kv_lora, vd, db)               # out expand
        else:
            c.gemm(B * T, a.kv_lora, H * (nope + vd), db)      # expand KV
            c.gemm(B * H * T, nope + rd, s_eff, db)
            c.gemm(B * H * T, s_eff, vd, db)
        c.gemm(B * T, H * vd, d, db)
    else:
        H, KV, hd = a.n_heads, a.n_kv_heads, a.head_dim
        c.gemm(B * T, d, (H + 2 * KV) * hd, db)                # qkv
        c.gemm(B * H * T, hd, s_eff, db)                       # scores
        c.gemm(B * H * T, s_eff, hd, db)                       # values
        c.gemm(B * T, H * hd, d, db)                           # out
    return c


def _mamba_cost(slot: LayerCfg, cfg: ArchConfig, B: float, T: float,
                db: int) -> Cost:
    c = Cost()
    m = slot.mamba
    d = cfg.d_model
    Di, N, Kc = m.d_inner, m.d_state, m.d_conv
    dtr = m.dt_rank or -(-d // 16)
    c.gemm(B * T, d, 2 * Di, db)
    c.ew(B * T * Di, flops_per=2 * Kc, db=db)                  # depthwise conv
    c.gemm(B * T, Di, dtr + 2 * N, db)
    c.gemm(B * T, dtr, Di, db)
    # selective scan: a = exp(dt·A), h = a·h + b, y = C·h, ~10 flops a state
    # element; the state (B, T, Di, N) read and written in float32
    c.ew(B * T * Di * N, flops_per=10.0, db=4)
    c.gemm(B * T, Di, d, db)
    return c


def _ffn_cost(slot: LayerCfg, cfg: ArchConfig, B: float, T: float,
              db: int) -> Cost:
    c = Cost()
    d = cfg.d_model
    nmat = 3 if cfg.gated_mlp else 2
    if slot.ffn == "dense":
        c.gemm(B * T, d, slot.d_ff, db, batch=nmat - 1)
        c.gemm(B * T, slot.d_ff, d, db)
    elif slot.ffn == "moe":
        mo = slot.moe
        c.gemm(B * T, d, mo.n_experts, db)                     # router
        ec = mo.capacity_factor * mo.top_k * B * T             # Σ_e C_e tokens
        c.gemm(ec, d, mo.d_ff_expert, db, batch=nmat - 1)
        c.gemm(ec, mo.d_ff_expert, d, db)
        c.ew(2 * ec * d, flops_per=0.0, db=db)                 # dispatch, combine
        if mo.n_shared:
            fs = mo.n_shared * mo.d_ff_expert
            c.gemm(B * T, d, fs, db, batch=nmat - 1)
            c.gemm(B * T, fs, d, db)
    return c


def forward_cost(cfg: ArchConfig, B: float, T: float, ctx: float,
                 causal: bool = True, db: int = 2) -> Cost:
    """One forward pass.  ``ctx``: the attention context (the cache for
    decode, == T for train and prefill)."""
    c = Cost()
    d = cfg.d_model
    for slot in cfg.layer_cfgs():
        if slot.mixer == "attn":
            c.add(_attn_cost(slot, cfg, B, T, ctx, causal, db))
        elif slot.mixer == "mamba":
            c.add(_mamba_cost(slot, cfg, B, T, db))
        c.ew(B * T * d, flops_per=8.0, db=db, reads=2, writes=1)  # norms, residual
        c.add(_ffn_cost(slot, cfg, B, T, db))
    # embeddings: the gather's read and the logits' GEMM
    c.ew(B * T * d, flops_per=0.0, db=db)
    c.gemm(B * T, d, cfg.vocab, db)
    if cfg.frontend is not None and T > 1:
        c.gemm(B * cfg.frontend.n_embeds, cfg.frontend.embed_dim, d, db)
    return c


def subcge_update_cost(cfg: ArchConfig, rank: int, n_clients: int,
                       db: int = 2) -> Cost:
    """n coefficients scattered, then U A V^T per 2D leaf instance (eq. 10);
    the leaves in the JAX package's flattening order."""
    from repro_torch.core.seeds import path_order
    from repro_torch.models import transformer as tf
    c = Cost()
    spec = tf.arch_spec(cfg)
    for path in path_order(spec):
        leaf = spec[path]
        tdims = leaf.shape[leaf.n_batch_dims:]
        inst = math.prod(leaf.shape[: leaf.n_batch_dims]) or 1
        if len(tdims) == 2:
            n, m = tdims
            c.gemm(n, rank, rank, db, batch=inst)              # U A
            c.gemm(n, rank, m, db, batch=inst)                 # (UA) V^T
            c.ew(inst * n * m, flops_per=1.0, db=db)           # W += Δ
        else:
            # the dense Gaussian: n_clients axpys and their draws
            sz = math.prod(tdims) * inst
            c.ew(sz * n_clients, flops_per=4.0, db=4)
    return c


def step_cost(cfg: ArchConfig, shape: InputShape, kind: str, *,
              rank: int = 32, n_clients: int = 16, db: int = 2) -> Cost:
    """One step of ``kind`` ("train": SeedFlood's two forwards and update;
    "train_dsgd": forward and backward, ~3 forwards; "prefill"; "decode":
    one token per sequence against a context of ``shape.seq``)."""
    B, T = shape.global_batch, shape.seq
    c = Cost()
    if kind == "train":
        f = forward_cost(cfg, B, T, T, causal=True, db=db)
        c.add(f, times=2.0)
        c.add(subcge_update_cost(cfg, rank, n_clients, db))
    elif kind == "train_dsgd":
        f = forward_cost(cfg, B, T, T, causal=True, db=db)
        c.add(f, times=3.0)
    elif kind == "prefill":
        c.add(forward_cost(cfg, B, T, T, causal=True, db=db))
    elif kind == "decode":
        c.add(forward_cost(cfg, B, 1.0, T, causal=False, db=db))
    else:
        raise ValueError(kind)
    return c
