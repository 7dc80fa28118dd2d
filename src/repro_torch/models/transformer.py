"""Decoder: spec, forward, loss and the serving caches (the dense,
MoE, MLA, Mamba-1, hybrid and frontend part of
``repro/models/transformer.py``).

``arch_spec`` produces the same leaf paths and shapes as the JAX package
(``embed/tok``, ``embed/out`` when untied, ``embed/pos`` for learned
positions, ``embed/ln_f_scale`` and, for layernorm, ``embed/ln_f_bias``,
``frontend/proj`` for a modality frontend, ``g{i}/s{j}/{wq,...}``,
``g{i}/s{j}/{wdq,...,wukv}`` (MLA) or ``g{i}/s{j}/{in_proj,...}``
(Mamba), then the slot's FFN or MoE leaves,
stacked over the group's reps, expert weights stacked over (reps,
experts)).  Every slot runs its mixer and then its FFN or MoE, as the JAX
``_apply_slot`` does.  The ``lax.scan`` over a group's periods becomes a
Python loop over the stacked layer axis; activations and parameters carry
a leading client axis.

The serving caches (``init_cache``, ``init_paged_pool``) are keyed by slot
(``"g0/s0"``), stacked over the group's reps, and serve one model: the
forward writes them in place.  A sliding-window slot's ring holds
``min(window, capacity)`` positions, as the JAX package's does; its paged
pool keeps every position's page, and the mask hides those past the
window.  An MLA slot's ring is the compressed one (``ckv``, ``krope``); a
Mamba slot's cache is its recurrent state ``(h, conv)``.  Like the JAX
package, the port pages neither, nor a frontend arch: its embeddings
enter through the monolithic prefill.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, AttnCfg, LayerCfg, MambaCfg
from repro_torch.models import layers as L
from repro_torch.models import params as plib
from repro_torch.models.params import LeafSpec, matrix, vector
from repro_torch.models.perturb import Bundle, Pert


#: OPT-style learned position table length (the JAX package's)
LEARNED_POS_LEN = 4_096


def _slot_ok(s: LayerCfg, cfg: ArchConfig) -> bool:
    if s.ffn == "moe" and not (cfg.act == "silu" and cfg.gated_mlp):
        return False                    # the MoE's experts are gated silu
    if (s.ffn == "moe") != (s.moe is not None):
        return False
    if s.mixer == "mamba":
        return (s.mamba is not None and s.attn is None
                and s.ffn in ("none", "dense", "moe"))
    return (s.mixer == "attn" and s.attn is not None and s.mamba is None
            and s.ffn in ("dense", "moe"))


def _check_supported(cfg: ArchConfig) -> None:
    slots = [s for g in cfg.groups for s in g.slots]
    ok = (cfg.norm in ("rmsnorm", "layernorm") and cfg.act in L.ACTS
          and cfg.pos in ("rope", "learned", "sinusoidal", "none"))
    if not (ok and all(_slot_ok(s, cfg) for s in slots)):
        raise NotImplementedError(
            f"{cfg.name}: the port runs rmsnorm or layernorm decoders with "
            "rope, learned or sinusoidal positions, attention (global or "
            "sliding-window "
            "GQA, or MLA) and a dense MLP (silu, gelu or relu, gated or "
            "not) or a gated silu MoE, or a Mamba-1 mixer followed by one of "
            "those or by no FFN")
    if cfg.pos == "none" and any(s.mixer == "attn" for s in slots):
        raise NotImplementedError(
            f"{cfg.name}: attention without positions is not ported (the "
            "port's attention takes rope, learned or sinusoidal positions)")


def _norm_spec(key: str, d: int, cfg: ArchConfig, st: tuple) -> dict:
    s = {key + "_scale": vector(d, stack=st)}
    if cfg.norm == "layernorm":
        s[key + "_bias"] = vector(d, stack=st)
    return s


def _mamba_spec(m: MambaCfg, d: int, st: tuple) -> dict[str, LeafSpec]:
    Di, N, Kc = m.d_inner, m.d_state, m.d_conv
    dtr = m.dt_rank or -(-d // 16)
    return {"in_proj": matrix(d, 2 * Di, stack=st),
            "conv_w": matrix(Di, Kc, stack=st),
            "conv_b": vector(Di, stack=st),
            "x_proj": matrix(Di, dtr + 2 * N, stack=st),
            "dt_proj": matrix(dtr, Di, stack=st),
            "dt_bias": vector(Di, stack=st, init="dt_bias"),
            "A_log": matrix(Di, N, stack=st, init="s4d"),
            "D_skip": vector(Di, stack=st, init="ones"),
            "out_proj": matrix(Di, d, stack=st)}


def _mla_spec(a: AttnCfg, d: int, st: tuple) -> dict[str, LeafSpec]:
    nope, rd, vd = L._mla_dims(a)
    H = a.n_heads
    if a.q_lora > 0:
        s = {"wdq": matrix(d, a.q_lora, stack=st),
             "q_ln_scale": vector(a.q_lora, stack=st),
             "wuq": matrix(a.q_lora, H * (nope + rd), stack=st)}
    else:
        s = {"wq": matrix(d, H * (nope + rd), stack=st)}
    s.update(wdkv=matrix(d, a.kv_lora + rd, stack=st),
             kv_ln_scale=vector(a.kv_lora, stack=st),
             wukv=matrix(a.kv_lora, H * (nope + vd), stack=st),
             wo=matrix(H * vd, d, stack=st))
    return s


def _slot_spec(slot: LayerCfg, cfg: ArchConfig,
               reps: int) -> dict[str, LeafSpec]:
    st, d = (reps,), cfg.d_model
    s = _norm_spec("ln_attn", d, cfg, st)
    a = slot.attn
    if slot.mixer == "mamba":
        s.update(_mamba_spec(slot.mamba, d, st))
    elif a.is_mla:
        s.update(_mla_spec(a, d, st))
    else:
        H, KV, hd = a.n_heads, a.n_kv_heads, a.head_dim
        s.update(wq=matrix(d, H * hd, stack=st),
                 wk=matrix(d, KV * hd, stack=st),
                 wv=matrix(d, KV * hd, stack=st),
                 wo=matrix(H * hd, d, stack=st))
        if a.qkv_bias:
            s.update(bq=vector(H * hd, stack=st),
                     bk=vector(KV * hd, stack=st),
                     bv=vector(KV * hd, stack=st))
    if slot.ffn == "none":
        return s
    s.update(_norm_spec("ln_mlp", d, cfg, st))
    if slot.ffn == "dense":
        s["w1"] = matrix(d, slot.d_ff, stack=st)
        if cfg.gated_mlp:
            s["w3"] = matrix(d, slot.d_ff, stack=st)
        s["w2"] = matrix(slot.d_ff, d, stack=st)
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
            **{"embed/" + k: v
               for k, v in _norm_spec("ln_f", cfg.d_model, cfg, ()).items()}}
    if not cfg.tie_embeddings:
        spec["embed/out"] = matrix(cfg.d_model, cfg.vocab)
    if cfg.pos == "learned":
        spec["embed/pos"] = matrix(LEARNED_POS_LEN, cfg.d_model, scale=0.02)
    if cfg.frontend is not None:
        spec["frontend/proj"] = matrix(cfg.frontend.embed_dim, cfg.d_model)
    for gi, g in enumerate(cfg.groups):
        for si, slot in enumerate(g.slots):
            for k, v in _slot_spec(slot, cfg, g.reps).items():
                spec[f"g{gi}/s{si}/{k}"] = v
    return spec


# ---------------------------------------------------------------------------
# serving caches (repro_torch.serve)
# ---------------------------------------------------------------------------

def _slots(cfg: ArchConfig):
    """(slot key, reps, LayerCfg) of every slot."""
    return [(f"g{gi}/s{si}", g.reps, slot)
            for gi, g in enumerate(cfg.groups)
            for si, slot in enumerate(g.slots)]


def init_cache(cfg: ArchConfig, B: int, capacity: int,
               dtype=torch.float32, device="cpu") -> dict:
    """Monolithic caches for B sequences of one model, keyed by slot.  An
    attention slot's is a ring of ``capacity`` positions (``min(window,
    capacity)`` in a sliding-window slot): {"k", "v": (reps, B, cap, KV,
    hd), "kpos": (reps, cap) int64, -1 where empty}; an MLA slot's is
    compressed: {"ckv": (reps, B, cap, kv_lora), "krope": (reps, B, cap,
    rope_head_dim), "kpos"}.  A Mamba slot's is its recurrent state, of no
    capacity: {"h": (reps, B, d_inner, d_state) float32, "conv": (reps, B,
    d_conv - 1, d_inner)}, the JAX package's shapes.  A frontend arch's
    prefill writes its P embeddings' positions too, so ``capacity`` counts
    them (P + prompt + new tokens)."""
    out = {}
    for key, reps, slot in _slots(cfg):
        if slot.mixer == "mamba":
            m = slot.mamba
            out[key] = {
                "h": torch.zeros((reps, B, m.d_inner, m.d_state),
                                 dtype=torch.float32, device=device),
                "conv": torch.zeros((reps, B, m.d_conv - 1, m.d_inner),
                                    dtype=dtype, device=device)}
            continue
        a = slot.attn
        cap = capacity if a.window is None else min(a.window, capacity)
        if a.is_mla:
            shapes = {"ckv": (reps, B, cap, a.kv_lora),
                      "krope": (reps, B, cap, a.rope_head_dim)}
        else:
            shape = (reps, B, cap, a.n_kv_heads, a.head_dim)
            shapes = {"k": shape, "v": shape}
        out[key] = {k: torch.zeros(sh, dtype=dtype, device=device)
                    for k, sh in shapes.items()}
        out[key]["kpos"] = torch.full((reps, cap), -1, dtype=torch.int64,
                                      device=device)
    return out


def check_paged_support(cfg: ArchConfig) -> None:
    """Paged serving covers text decode over standard (GQA) attention
    slots; MLA's compressed cache and Mamba's recurrent state need their
    own paging story, and a frontend arch serves through the monolithic
    prefill, as in the JAX package."""
    if cfg.frontend is not None:
        raise ValueError("paged serving is text-decode only (frontend archs "
                         "serve through the monolithic path)")
    for g in cfg.groups:
        for slot in g.slots:
            if slot.mixer == "mamba":
                raise ValueError("paged serving does not support mamba slots")
            if slot.mixer == "attn" and slot.attn.is_mla:
                raise ValueError("paged serving does not support MLA slots")


def init_paged_pool(cfg: ArchConfig, n_pages: int, page_size: int,
                    dtype=torch.float32, device="cpu") -> dict:
    """Per-attention-slot page pools of ``n_pages + 1`` physical pages, the
    last one the dump page: slot -> {"k", "v": (reps, n_pages + 1,
    page_size, KV, hd)}."""
    check_paged_support(cfg)
    out = {}
    for key, reps, slot in _slots(cfg):
        a = slot.attn
        shape = (reps, n_pages + 1, page_size, a.n_kv_heads, a.head_dim)
        out[key] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device)}
    return out


def write_prefill_to_pages(cache: dict, pool: dict, table: torch.Tensor,
                           page_size: int) -> dict:
    """Scatter a freshly prefilled monolithic cache into pool pages, in
    place; ``table`` (Bg, pages) holds the Bg admitted requests' page rows.
    Every ring slot goes to the page of the position its ``kpos`` records
    (the same in every layer of a slot: a prefill writes them all at once),
    and empty slots (-1) are skipped.  A full ring (capacity == prompt
    length T) holds position s in slot s, and this is the plain scatter; a
    sliding-window ring shorter than T holds the last ``window`` positions
    at slots ``p % window``, and they land where paged decode reads them.
    The pages of older positions stay unwritten: every decode query is at
    a position >= T, and the window's mask drops them.

    The JAX package's ``write_prefill_to_pages`` assumes slot s holds
    position s in every ring, so past the window it writes the kept
    positions to the wrong pages and leaves the window's pages empty; the
    port does not copy that (its paged decode is held to the JAX package's
    monolithic path instead).  Prefill logits never read the cache layout,
    so prefill-then-scatter is the monolithic prefill."""
    for key, c in cache.items():
        p = pool[key]
        kpos = c["kpos"][0]
        live = torch.nonzero(kpos >= 0)[:, 0]
        pos = kpos[live]
        phys = table[:, pos // page_size]                      # (Bg, n)
        off = (pos % page_size).expand_as(phys)
        p["k"][:, phys, off] = c["k"][:, :, live].to(p["k"].dtype)
        p["v"][:, phys, off] = c["v"][:, :, live].to(p["v"].dtype)
    return pool


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer_cache(cache: dict | None, key: str, layer: int) -> dict | None:
    if cache is None:
        return None
    return {k: t[layer] for k, t in cache[key].items()}


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            embeds: torch.Tensor | None = None,
            sub: dict | None = None, pert: Pert | None = None,
            cache: dict | None = None, pos=0,
            paged_table: torch.Tensor | None = None):
    """(logits (C, B, P + T, vocab), aux (C,)) for tokens (C, B, T); params
    stacked (C, ...).  ``aux`` sums the MoE load-balance losses of every
    layer (0 for a dense decoder).

    ``embeds`` (C, B, P, edim) are a frontend arch's stubbed frame or patch
    embeddings (P = 0 without them): projected by ``frontend/proj`` (a
    perturbed projection like any other) and prepended to the token
    embeddings before positions are added, so they take positions
    pos..pos+P-1.  An arch without a frontend ignores them, as the JAX
    package does.  Sinusoidal positions are added at every position,
    unclipped.

    Serving (one model, C = 1): with ``cache`` from :func:`init_cache`,
    ``pos`` (an int) is the absolute position of tokens[..., 0] and every
    slot's cache is written in place.  With ``paged_table`` (B, Pb) as well,
    ``cache`` is a pool from :func:`init_paged_pool`, ``pos`` a (B,)
    tensor of per-request positions, T is 1, and attention runs
    :func:`~repro_torch.models.layers.paged_attention` (written in place
    too).  Learned positions are clipped at ``LEARNED_POS_LEN - 1``.
    An MLA slot runs :func:`~repro_torch.models.layers.mla_attention`
    and a Mamba slot :func:`~repro_torch.models.layers.mamba` (a prefill or
    one decode step on its ``(h, conv)`` state with a cache; neither has a
    paged path).  Every slot's FFN or MoE follows its mixer."""
    if paged_table is not None:
        check_paged_support(cfg)
    emb = Bundle(params, sub, pert, "embed/")
    x = emb.embed("tok", tokens)
    if embeds is not None and "frontend/proj" in params:
        xf = Bundle(params, sub, pert, "frontend/").dense(
            "proj", embeds.to(x.dtype))
        x = torch.cat([xf, x], dim=2)
    C, _, T = x.shape[:3]
    if cfg.pos in ("learned", "sinusoidal"):
        # positions pos..pos+T-1 shared by every sequence (1, T), or per
        # request (B, T) on the paged path
        steps = torch.arange(T, device=tokens.device)
        q_pos = pos[:, None] + steps if paged_table is not None \
            else (pos + steps)[None]
        if cfg.pos == "learned":
            ids = q_pos.clamp(0, LEARNED_POS_LEN - 1)[None]
            x = x + emb.embed("pos", ids.expand(C, -1, -1))
        else:
            x = x + L.sinusoidal_pos(q_pos, cfg.d_model)[None].to(x.dtype)
    aux = torch.zeros(C, dtype=torch.float32, device=tokens.device)
    for gi, g in enumerate(cfg.groups):
        for layer in range(g.reps):
            for si, slot in enumerate(g.slots):
                b = Bundle(params, sub, pert, f"g{gi}/s{si}/", layer)
                h = L.norm(b, "ln_attn", x, cfg.norm)
                lc = _layer_cache(cache, f"g{gi}/s{si}", layer)
                if slot.mixer == "mamba":
                    x = x + L.mamba(b, h, slot.mamba, lc)
                elif slot.attn.is_mla:
                    x = x + L.mla_attention(b, h, slot.attn, cfg.rope_theta,
                                            pos, lc)
                elif paged_table is not None:
                    x = x + L.paged_attention(b, h, slot.attn,
                                              cfg.rope_theta, cfg.pos, pos,
                                              lc, paged_table)
                else:
                    x = x + L.attention(b, h, slot.attn, cfg.rope_theta,
                                        cfg.pos, pos, lc)
                if slot.ffn == "moe":
                    y, a = L.moe(b, L.norm(b, "ln_mlp", x, cfg.norm),
                                 slot.moe)
                    x = x + y
                    aux = aux + a
                elif slot.ffn == "dense":
                    x = x + L.mlp(b, L.norm(b, "ln_mlp", x, cfg.norm),
                                  cfg.act, cfg.gated_mlp)
    x = L.norm(emb, "ln_f", x, cfg.norm)
    if cfg.tie_embeddings:
        return emb.dense_t("tok", x), aux
    return emb.dense("out", x), aux


def lm_loss(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            embeds: torch.Tensor | None = None,
            sub: dict | None = None, pert: Pert | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy per client over the text segment, plus
    its MoE aux loss: (C,).  A frontend's ``embeds`` are context only: the
    logits of their P positions are not scored.

    The mean over tokens is taken in float64 and rounded once: the ZO
    coefficient (L+ − L−) / 2ε divides the difference of two float32 losses
    by 2ε, so the losses' own rounding sets its noise floor."""
    logits, aux = forward(cfg, params, tokens, embeds=embeds, sub=sub,
                          pert=pert)
    off = logits.shape[2] - tokens.shape[2]          # n frontend embeds
    lg = logits[:, :, off:-1].float()
    del logits
    labels = tokens[:, :, 1:].long()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None])[..., 0]
    return ((lse - gold).double().mean(dim=(1, 2)) + aux.double()).float()


def init_params(cfg: ArchConfig, seed: int = 0, device="cpu",
                dtype=torch.float32) -> dict:
    return plib.init_params(arch_spec(cfg), seed, device, dtype)


def count_params(cfg: ArchConfig) -> int:
    return plib.n_params(arch_spec(cfg))
