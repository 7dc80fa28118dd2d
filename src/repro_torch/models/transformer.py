"""Decoder: spec builder, forward and loss (the dense, MoE and Mamba-1 part
of ``repro/models/transformer.py``).

``arch_spec`` produces the same leaf paths and shapes as the JAX package
(``embed/tok``, ``embed/out`` when untied, ``embed/ln_f_scale``,
``g{i}/s{j}/{wq,...}`` or ``g{i}/s{j}/{in_proj,...}`` stacked over the
group's reps, expert weights stacked over (reps, experts)).  The
``lax.scan`` over a group's periods becomes a Python loop over the stacked
layer axis; activations and parameters carry a leading client axis.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, LayerCfg, MambaCfg
from repro_torch.models import layers as L
from repro_torch.models import params as plib
from repro_torch.models.params import LeafSpec, matrix, vector
from repro_torch.models.perturb import Bundle, Pert


def _slot_ok(s: LayerCfg) -> bool:
    if s.mixer == "mamba":
        return s.mamba is not None and s.ffn == "none" and s.moe is None
    return (s.mixer == "attn" and s.attn is not None and s.mamba is None
            and s.ffn in ("dense", "moe")
            and (s.ffn == "dense") == (s.moe is None))


def _check_supported(cfg: ArchConfig) -> None:
    slots = [s for g in cfg.groups for s in g.slots]
    ok = (cfg.norm == "rmsnorm" and cfg.act == "silu" and cfg.gated_mlp
          and cfg.pos in ("rope", "none"))
    if not (ok and all(_slot_ok(s) for s in slots)):
        raise NotImplementedError(
            f"{cfg.name}: the port runs rmsnorm / silu gated decoders with "
            "attention and a dense or MoE FFN, or a Mamba-1 mixer and no FFN")
    if cfg.pos == "none" and any(s.mixer == "attn" for s in slots):
        raise NotImplementedError(
            f"{cfg.name}: attention without positions is not ported (the "
            "port's attention always applies rope)")


def _mamba_spec(m: MambaCfg, d: int, st: tuple) -> dict[str, LeafSpec]:
    Di, N, Kc = m.d_inner, m.d_state, m.d_conv
    dtr = m.dt_rank or -(-d // 16)
    return {"ln_attn_scale": vector(d, stack=st),
            "in_proj": matrix(d, 2 * Di, stack=st),
            "conv_w": matrix(Di, Kc, stack=st),
            "conv_b": vector(Di, stack=st),
            "x_proj": matrix(Di, dtr + 2 * N, stack=st),
            "dt_proj": matrix(dtr, Di, stack=st),
            "dt_bias": vector(Di, stack=st, init="dt_bias"),
            "A_log": matrix(Di, N, stack=st, init="s4d"),
            "D_skip": vector(Di, stack=st, init="ones"),
            "out_proj": matrix(Di, d, stack=st)}


def _slot_spec(slot: LayerCfg, d: int, reps: int) -> dict[str, LeafSpec]:
    st = (reps,)
    if slot.mixer == "mamba":
        return _mamba_spec(slot.mamba, d, st)
    a = slot.attn
    H, KV, hd = a.n_heads, a.n_kv_heads, a.head_dim
    s = {"ln_attn_scale": vector(d, stack=st),
         "wq": matrix(d, H * hd, stack=st),
         "wk": matrix(d, KV * hd, stack=st),
         "wv": matrix(d, KV * hd, stack=st),
         "wo": matrix(H * hd, d, stack=st)}
    if a.qkv_bias:
        s.update(bq=vector(H * hd, stack=st), bk=vector(KV * hd, stack=st),
                 bv=vector(KV * hd, stack=st))
    s["ln_mlp_scale"] = vector(d, stack=st)
    if slot.ffn == "dense":
        s.update(w1=matrix(d, slot.d_ff, stack=st),
                 w3=matrix(d, slot.d_ff, stack=st),
                 w2=matrix(slot.d_ff, d, stack=st))
    else:
        mo = slot.moe
        est = st + (mo.n_experts,)
        s.update(router=matrix(d, mo.n_experts, stack=st),
                 w1=matrix(d, mo.d_ff_expert, stack=est),
                 w3=matrix(d, mo.d_ff_expert, stack=est),
                 w2=matrix(mo.d_ff_expert, d, stack=est))
        if mo.n_shared > 0:
            fs = mo.n_shared * mo.d_ff_expert
            s.update(sw1=matrix(d, fs, stack=st), sw3=matrix(d, fs, stack=st),
                     sw2=matrix(fs, d, stack=st))
    return s


def arch_spec(cfg: ArchConfig) -> dict[str, LeafSpec]:
    """Flat path -> LeafSpec."""
    _check_supported(cfg)
    spec = {"embed/tok": matrix(cfg.vocab, cfg.d_model, scale=0.02),
            "embed/ln_f_scale": vector(cfg.d_model)}
    if not cfg.tie_embeddings:
        spec["embed/out"] = matrix(cfg.d_model, cfg.vocab)
    for gi, g in enumerate(cfg.groups):
        for si, slot in enumerate(g.slots):
            for k, v in _slot_spec(slot, cfg.d_model, g.reps).items():
                spec[f"g{gi}/s{si}/{k}"] = v
    return spec


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            sub: dict | None = None, pert: Pert | None = None):
    """(logits (C, B, T, vocab), aux (C,)) for tokens (C, B, T); params
    stacked (C, ...).  ``aux`` sums the MoE load-balance losses of every
    layer (0 for a dense decoder)."""
    emb = Bundle(params, sub, pert, "embed/")
    x = emb.embed("tok", tokens)
    aux = torch.zeros(tokens.shape[0], dtype=torch.float32,
                      device=tokens.device)
    for gi, g in enumerate(cfg.groups):
        for layer in range(g.reps):
            for si, slot in enumerate(g.slots):
                b = Bundle(params, sub, pert, f"g{gi}/s{si}/", layer)
                h = L.norm(b, "ln_attn", x)
                if slot.mixer == "mamba":
                    x = x + L.mamba(b, h, slot.mamba)
                else:
                    x = x + L.attention(b, h, slot.attn, cfg.rope_theta)
                if slot.ffn == "moe":
                    y, a = L.moe(b, L.norm(b, "ln_mlp", x), slot.moe)
                    x = x + y
                    aux = aux + a
                elif slot.ffn == "dense":
                    x = x + L.mlp(b, L.norm(b, "ln_mlp", x))
    x = L.norm(emb, "ln_f", x)
    if cfg.tie_embeddings:
        return emb.dense_t("tok", x), aux
    return emb.dense("out", x), aux


def lm_loss(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            sub: dict | None = None, pert: Pert | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy per client, plus its MoE aux loss: (C,).

    The mean over tokens is taken in float64 and rounded once: the ZO
    coefficient (L+ − L−) / 2ε divides the difference of two float32 losses
    by 2ε, so the losses' own rounding sets its noise floor."""
    logits, aux = forward(cfg, params, tokens, sub=sub, pert=pert)
    lg = logits[:, :, :-1].float()
    del logits
    labels = tokens[:, :, 1:].long()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None])[..., 0]
    return ((lse - gold).double().mean(dim=(1, 2)) + aux.double()).float()


def init_params(cfg: ArchConfig, seed: int = 0, device="cpu") -> dict:
    return plib.init_params(arch_spec(cfg), seed, device)
