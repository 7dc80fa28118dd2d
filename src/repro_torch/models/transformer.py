"""Dense decoder: spec builder, forward and loss (the dense part of
``repro/models/transformer.py``).

``arch_spec`` produces the same leaf paths and shapes as the JAX package
(``embed/tok``, ``embed/ln_f_scale``, ``g{i}/s{j}/{wq,...}`` stacked over
the group's reps).  The ``lax.scan`` over a group's periods becomes a
Python loop over the stacked layer axis; activations and parameters carry
a leading client axis.
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
          and cfg.pos == "rope" and cfg.tie_embeddings)
    slots_ok = all(s.mixer == "attn" and s.ffn == "dense"
                   for g in cfg.groups for s in g.slots)
    if not (ok and slots_ok):
        raise NotImplementedError(
            f"{cfg.name}: the port runs rmsnorm / silu gated MLP / rope / "
            "tied-embedding dense decoders only")


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
    s.update(ln_mlp_scale=vector(d, stack=st),
             w1=matrix(d, slot.d_ff, stack=st),
             w3=matrix(d, slot.d_ff, stack=st),
             w2=matrix(slot.d_ff, d, stack=st))
    return s


def arch_spec(cfg: ArchConfig) -> dict[str, LeafSpec]:
    """Flat path -> LeafSpec."""
    _check_supported(cfg)
    spec = {"embed/tok": matrix(cfg.vocab, cfg.d_model, scale=0.02),
            "embed/ln_f_scale": vector(cfg.d_model)}
    for gi, g in enumerate(cfg.groups):
        for si, slot in enumerate(g.slots):
            for k, v in _slot_spec(slot, cfg.d_model, g.reps).items():
                spec[f"g{gi}/s{si}/{k}"] = v
    return spec


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            sub: dict | None = None, pert: Pert | None = None):
    """Logits (C, B, T, vocab) for tokens (C, B, T); params stacked (C, ...)."""
    emb = Bundle(params, sub, pert, "embed/")
    x = emb.embed("tok", tokens)
    for gi, g in enumerate(cfg.groups):
        for layer in range(g.reps):
            for si, slot in enumerate(g.slots):
                b = Bundle(params, sub, pert, f"g{gi}/s{si}/", layer)
                x = x + L.attention(b, L.norm(b, "ln_attn", x), slot.attn,
                                    cfg.rope_theta)
                x = x + L.mlp(b, L.norm(b, "ln_mlp", x))
    x = L.norm(emb, "ln_f", x)
    return emb.dense_t("tok", x)


def lm_loss(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            sub: dict | None = None, pert: Pert | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy per client: (C,)."""
    logits = forward(cfg, params, tokens, sub=sub, pert=pert)
    lg = logits[:, :, :-1].float()
    del logits
    labels = tokens[:, :, 1:].long()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None])[..., 0]
    return (lse - gold).mean(dim=(1, 2))


def init_params(cfg: ArchConfig, seed: int = 0, device="cpu") -> dict:
    return plib.init_params(arch_spec(cfg), seed, device)
