"""Decoder: spec builder, forward and loss (the dense and MoE part of
``repro/models/transformer.py``).

``arch_spec`` produces the same leaf paths and shapes as the JAX package
(``embed/tok``, ``embed/out`` when untied, ``embed/ln_f_scale``,
``g{i}/s{j}/{wq,...}`` stacked over the group's reps, expert weights
stacked over (reps, experts)).  The ``lax.scan`` over a group's periods
becomes a Python loop over the stacked layer axis; activations and
parameters carry a leading client axis.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, LayerCfg
from repro_torch.models import layers as L
from repro_torch.models import params as plib
from repro_torch.models.params import LeafSpec, matrix, vector
from repro_torch.models.perturb import Bundle, Pert


def _check_supported(cfg: ArchConfig) -> None:
    ok = (cfg.norm == "rmsnorm" and cfg.act == "silu" and cfg.gated_mlp
          and cfg.pos == "rope")
    slots_ok = all(s.mixer == "attn" and s.ffn in ("dense", "moe")
                   and (s.ffn == "dense") == (s.moe is None)
                   for g in cfg.groups for s in g.slots)
    if not (ok and slots_ok):
        raise NotImplementedError(
            f"{cfg.name}: the port runs rmsnorm / silu gated / rope "
            "decoders with attention and dense or MoE FFNs only")


def _slot_spec(slot: LayerCfg, d: int, reps: int) -> dict[str, LeafSpec]:
    st = (reps,)
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
                x = x + L.attention(b, L.norm(b, "ln_attn", x), slot.attn,
                                    cfg.rope_theta)
                h = L.norm(b, "ln_mlp", x)
                if slot.ffn == "moe":
                    y, a = L.moe(b, h, slot.moe)
                    x = x + y
                    aux = aux + a
                else:
                    x = x + L.mlp(b, h)
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
