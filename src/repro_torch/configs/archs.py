"""Architectures the port runs (the dense, MoE, MLA, SSM, hybrid, audio and
vision subset of ``repro/configs/archs.py``, and the paper's own OPT
family).  TinyLlama 1.1B is the serving path's model
(``repro_torch.launch.serve``'s default).  MusicGen-medium and InternVL2-26B
keep the JAX package's stubbed frontends: a T5 text-conditioning encoder
and InternViT-6B are not modelled, their outputs come in as embeddings,
and only the linear projector onto d_model is trained.

``reduced`` mirrors the JAX package's smoke variant: one layer per distinct
slot, d_model 64, at most 4 heads, d_ff 2·d, vocab 256; a sliding-window
slot keeps a window of 16; an MLA slot gets q_lora 32, kv_lora 16, a
rope head of 8 and a value head of head_dim; an MoE slot keeps 4 experts,
top-min(2, k), expert width 2·d, at most one shared expert and capacity
factor 8 (drop-free); a Mamba slot gets d_inner 2·d, state 4, conv 4 and
dt_rank 8; a frontend keeps 8 embeddings of width 32.

``kimi_cut``, ``falcon_cut``, ``qwen2_cut``, ``internvl_cut``,
``deepseek_cut`` and ``jamba_cut`` are the one-card cuts of Kimi K2, Falcon
Mamba 7B, Qwen2-72B, InternVL2-26B, DeepSeek-V2 and Jamba-1.5-Large that
``chip_smoke.py`` trains: every width as published, depth and experts cut
(``KIMI_*``, ``FALCON_LAYERS``, ``QWEN2_LAYERS``, ``INTERNVL_LAYERS``,
``DEEPSEEK_*``, ``JAMBA_EXPERTS``).  Gemma 3 1B and MusicGen-medium run
whole, and Falcon Mamba 7B serves whole.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, AttnCfg, FrontendCfg, \
    Group, LayerCfg, MambaCfg, MoECfg, dense_layer, uniform_dense

QWEN15_05B = uniform_dense(
    "qwen1.5-0.5b", n_layers=24, d_model=1024, n_heads=16, n_kv=16,
    d_ff=2816, vocab=151_936, qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6,
    source="[hf:Qwen/Qwen1.5-0.5B] 24L d1024 16H(kv16) ff2816 v151936, QKV bias")

TINYLLAMA_11B = uniform_dense(
    "tinyllama-1.1b", n_layers=22, d_model=2048, n_heads=32, n_kv=4,
    d_ff=5632, vocab=32_000, rope_theta=1e4,
    source="[arXiv:2401.02385] 22L d2048 32H(kv4) ff5632 v32000, llama2-arch")

QWEN2_72B = uniform_dense(
    "qwen2-72b", n_layers=80, d_model=8192, n_heads=64, n_kv=8,
    d_ff=29_568, vocab=152_064, qkv_bias=True, rope_theta=1e6,
    source="[arXiv:2407.10671] 80L d8192 64H(kv8) ff29568 v152064, GQA+QKV bias")


def _gemma3_groups() -> tuple[Group, ...]:
    """26 layers, 5 local (sw=512) : 1 global -> 4 full periods + 2 local."""
    local = dense_layer(1152, 4, 1, 6912, head_dim=256, window=512)
    glob = dense_layer(1152, 4, 1, 6912, head_dim=256, window=None)
    return (Group((local,) * 5 + (glob,), 4), Group((local,), 2))


GEMMA3_1B = ArchConfig(
    name="gemma3-1b", family="dense", d_model=1152, vocab=262_144,
    groups=_gemma3_groups(), act="gelu", tie_embeddings=True,
    rope_theta=1e6,
    source="[hf:google/gemma-3-1b-pt] 26L d1152 4H(kv1,hd256) ff6912 "
           "v262144, 5:1 local(sw512):global, 128k ctx")

KIMI_K2 = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe", d_model=7168, vocab=163_840,
    groups=(Group((LayerCfg(
        mixer="attn", attn=AttnCfg(n_heads=64, n_kv_heads=8, head_dim=128),
        ffn="moe", moe=MoECfg(n_experts=384, top_k=8, d_ff_expert=2048,
                              n_shared=1, router_aux=0.001)),), 61),),
    rope_theta=5e4,
    source="[arXiv:2501.kimi2] 61L d7168 64H(kv8) MoE 384e top-8 +1 shared, "
           "expert ff2048, v163840 — 1T total / ~32B active")

def _dsv2_attn() -> AttnCfg:
    return AttnCfg(n_heads=128, n_kv_heads=128, head_dim=128,
                   q_lora=1536, kv_lora=512, rope_head_dim=64, v_head_dim=128)


def _dsv2_groups() -> tuple[Group, ...]:
    dense0 = LayerCfg(mixer="attn", attn=_dsv2_attn(), ffn="dense", d_ff=12_288)
    moe = LayerCfg(mixer="attn", attn=_dsv2_attn(), ffn="moe",
                   moe=MoECfg(n_experts=160, top_k=6, d_ff_expert=1536,
                              n_shared=2, router_aux=0.001))
    return (Group((dense0,), 1), Group((moe,), 59))


DEEPSEEK_V2 = ArchConfig(
    name="deepseek-v2-236b", family="moe", d_model=5120, vocab=102_400,
    groups=_dsv2_groups(), rope_theta=1e4,
    source="[arXiv:2405.04434] 60L d5120 128H MLA(q_lora1536,kv_lora512,"
           "rope64) MoE 160e top-6 + 2 shared, expert ff1536, v102400")

FALCON_MAMBA_7B = ArchConfig(
    name="falcon-mamba-7b", family="ssm", d_model=4096, vocab=65_024,
    groups=(Group((LayerCfg(
        mixer="mamba", mamba=MambaCfg(d_inner=8192, d_state=16, d_conv=4),
        ffn="none"),), 64),),
    pos="none",
    source="[arXiv:2410.05355] 64L d4096 mamba1 (d_inner 8192, state 16, "
           "conv 4), attention-free, v65024")


def _jamba_groups() -> tuple[Group, ...]:
    """Period of 8: attention at slot 0, Mamba at 1..7; MoE (16e top-2) on
    every other layer [arXiv:2403.19887]."""
    attn = AttnCfg(n_heads=64, n_kv_heads=8, head_dim=128)
    mam = MambaCfg(d_inner=2 * 8192, d_state=16, d_conv=4)
    moe = MoECfg(n_experts=16, top_k=2, d_ff_expert=24_576, router_aux=0.001)
    slots = []
    for idx in range(8):
        mixer = "attn" if idx == 0 else "mamba"
        ffn = "moe" if idx % 2 == 1 else "dense"
        slots.append(LayerCfg(
            mixer=mixer,
            attn=attn if mixer == "attn" else None,
            mamba=mam if mixer == "mamba" else None,
            ffn=ffn, d_ff=24_576 if ffn == "dense" else 0,
            moe=moe if ffn == "moe" else None))
    return (Group(tuple(slots), 9),)


JAMBA_15_LARGE = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid", d_model=8192, vocab=65_536,
    groups=_jamba_groups(),
    source="[arXiv:2403.19887] 72L d8192 64H(kv8), Mamba:attn 7:1, "
           "MoE 16e top-2 every other layer, ff24576, v65536 — 398B total")


MUSICGEN_MEDIUM = ArchConfig(
    name="musicgen-medium", family="audio", d_model=1536, vocab=2048,
    groups=(Group((dense_layer(1536, 24, 24, 6144),), 48),),
    gated_mlp=False, act="gelu", norm="layernorm", pos="sinusoidal",
    frontend=FrontendCfg(kind="audio_cond", n_embeds=64, embed_dim=768,
                         source="T5-encoder conditioning (stub)"),
    source="[arXiv:2306.05284] 48L d1536 24H ff6144 v2048 decoder over "
           "EnCodec tokens; text-conditioning frontend stubbed")

INTERNVL2_26B = ArchConfig(
    name="internvl2-26b", family="vlm", d_model=6144, vocab=92_553,
    groups=(Group((dense_layer(6144, 48, 8, 16_384),), 48),),
    rope_theta=1e6,
    frontend=FrontendCfg(kind="vision", n_embeds=1024, embed_dim=3200,
                         source="InternViT-6B patch embeddings (stub)"),
    source="[arXiv:2404.16821] InternLM2 backbone: 48L d6144 48H(kv8) "
           "ff16384 v92553; InternViT-6B stubbed, projector trained")


def _opt(name: str, n_layers: int, d: int, h: int, ff: int) -> ArchConfig:
    return uniform_dense(
        name, n_layers=n_layers, d_model=d, n_heads=h, n_kv=h, d_ff=ff,
        vocab=50_272, qkv_bias=True, gated_mlp=False, act="relu",
        norm="layernorm", pos="learned", tie_embeddings=True,
        source="[arXiv:2205.01068] OPT family (paper's experiments)")


OPT_125M = _opt("opt-125m", 12, 768, 12, 3072)
OPT_1_3B = _opt("opt-1.3b", 24, 2048, 32, 8192)
OPT_2_7B = _opt("opt-2.7b", 32, 2560, 32, 10_240)

REGISTRY: dict[str, ArchConfig] = {
    c.name: c for c in [QWEN15_05B, TINYLLAMA_11B, QWEN2_72B, GEMMA3_1B,
                        KIMI_K2, DEEPSEEK_V2, FALCON_MAMBA_7B,
                        JAMBA_15_LARGE, MUSICGEN_MEDIUM, INTERNVL2_26B,
                        OPT_125M, OPT_1_3B, OPT_2_7B]}


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch '{name}' (have {sorted(REGISTRY)})")
    return REGISTRY[name]


#: Kimi K2 cut to one card's share (published: 61 layers, 384 experts, vocab
#: 163840): every layer is the same slot, 32 experts are what one of 12
#: expert-parallel cards holds (the router is cut with them), and the
#: vocabulary is cut to one eighth; every width stays as published
KIMI_LAYERS, KIMI_EXPERTS, KIMI_VOCAB = 1, 32, 20_480
#: Falcon Mamba 7B cut in depth only (published: 64 layers): every layer is
#: the same slot; 64 layers x 8 client replicas would be 232.7 GB
FALCON_LAYERS = 4
#: Qwen2-72B cut in depth only (published: 80 layers): every layer is the
#: same slot; one layer is 0.88 B parameters and the untied embeddings
#: 2 x 1.25 B, so one client holds 3.37 B float32 (13.5 GB) and 4 clients
#: 54 GB; 80 layers would be 290 GB for one client alone
QWEN2_LAYERS = 1
#: InternVL2-26B cut in depth only (published: 48 layers): every layer is
#: the same slot; one layer is 390 M parameters and the untied embeddings
#: 2 x 569 M, so the cut with its 20 M projector holds 1,547,040,768
#: float32 (5.76 GiB); 48 layers would be 74.1 GiB before any activation
INTERNVL_LAYERS = 1
#: DeepSeek-V2 cut to one card's share (published: 60 layers, a dense first
#: layer and then 59 MoE layers of 160 routed experts):
#: - the dense layer stays whole (its group is one layer);
#: - 1 of the 59 MoE layers, all alike;
#: - 20 of 160 routed experts, one rank's share under the 8-way expert
#:   parallelism the DeepSeek-V2 paper trains with; the router is cut with
#:   them, as Kimi's is;
#: every width and the untied 102,400 vocabulary stay as published: 2.05 B
#: float32 a client (8.2 GB), so 4 clients on a ring take 32.9 GB
DEEPSEEK_MOE_LAYERS, DEEPSEEK_EXPERTS = 1, 20
#: Jamba-1.5-Large cut to one card's share (published: 9 periods of 8
#: slots, attention at slot 0 and Mamba at 1-7, a 16-expert MoE at the odd
#: slots and a dense FFN at the even ones):
#: - the period's first two slots, one rep each: attention with the dense
#:   FFN, Mamba with the MoE (the two slot kinds ``reduced`` keeps);
#: - 2 of 16 experts, still top-2, one rank's share under 8-way expert
#:   parallelism; the router is cut with them;
#: every width and the untied 65,536 vocabulary stay as published:
#: 3,457,064,960 float32 a client (13.8 GB), so 4 clients take 55.3 GB
JAMBA_EXPERTS = 2


def kimi_cut(cfg: ArchConfig = KIMI_K2) -> ArchConfig:
    """Kimi K2 at its published widths, cut to one card's share."""
    slot = cfg.groups[0].slots[0]
    moe = dataclasses.replace(slot.moe, n_experts=KIMI_EXPERTS)
    return dataclasses.replace(
        cfg, name=cfg.name + "-cut", vocab=KIMI_VOCAB,
        groups=(Group((dataclasses.replace(slot, moe=moe),), KIMI_LAYERS),))


def falcon_cut(cfg: ArchConfig = FALCON_MAMBA_7B) -> ArchConfig:
    """Falcon Mamba 7B at its published widths, cut in depth."""
    return dataclasses.replace(
        cfg, name=cfg.name + "-cut",
        groups=(Group(cfg.groups[0].slots, FALCON_LAYERS),))


def qwen2_cut(cfg: ArchConfig = QWEN2_72B) -> ArchConfig:
    """Qwen2-72B at its published widths and untied vocabulary, cut in
    depth."""
    return dataclasses.replace(
        cfg, name=cfg.name + "-cut",
        groups=(Group(cfg.groups[0].slots, QWEN2_LAYERS),))


def internvl_cut(cfg: ArchConfig = INTERNVL2_26B) -> ArchConfig:
    """InternVL2-26B at its published widths, untied vocabulary and
    projector, cut in depth."""
    return dataclasses.replace(
        cfg, name=cfg.name + "-cut",
        groups=(Group(cfg.groups[0].slots, INTERNVL_LAYERS),))


def deepseek_cut(cfg: ArchConfig = DEEPSEEK_V2) -> ArchConfig:
    """DeepSeek-V2 at its published widths and untied vocabulary: the dense
    layer, one MoE layer, its experts cut to one rank's share."""
    dense, moe = cfg.groups
    slot = moe.slots[0]
    slot = dataclasses.replace(slot, moe=dataclasses.replace(
        slot.moe, n_experts=DEEPSEEK_EXPERTS))
    return dataclasses.replace(
        cfg, name=cfg.name + "-cut",
        groups=(dense, Group((slot,), DEEPSEEK_MOE_LAYERS)))


def jamba_cut(cfg: ArchConfig = JAMBA_15_LARGE) -> ArchConfig:
    """Jamba-1.5-Large at its published widths and untied vocabulary: the
    period's attention + dense slot and Mamba + MoE slot, once each, the
    experts cut to one rank's share."""
    attn, mam = cfg.groups[0].slots[:2]
    mam = dataclasses.replace(mam, moe=dataclasses.replace(
        mam.moe, n_experts=JAMBA_EXPERTS))
    return dataclasses.replace(cfg, name=cfg.name + "-cut",
                               groups=(Group((attn, mam), 1),))


def _shrink_attn(a: AttnCfg | None, d: int) -> AttnCfg | None:
    if a is None:
        return None
    h = max(2, min(a.n_heads, 4))
    kv = 1 if a.n_kv_heads < a.n_heads else h
    hd = max(8, d // h)
    return AttnCfg(h, kv, hd, a.qkv_bias,
                   None if a.window is None else 16,
                   q_lora=32 if a.q_lora else 0,
                   kv_lora=16 if a.kv_lora else 0,
                   rope_head_dim=8 if a.rope_head_dim else 0,
                   v_head_dim=hd if a.v_head_dim else 0)


def _shrink_slot(s: LayerCfg, d: int) -> LayerCfg:
    mam = None
    if s.mamba is not None:
        mam = MambaCfg(d_inner=2 * d, d_state=4, d_conv=4, dt_rank=8)
    moe = None
    if s.moe is not None:
        moe = MoECfg(n_experts=4, top_k=min(2, s.moe.top_k), d_ff_expert=2 * d,
                     n_shared=min(1, s.moe.n_shared), capacity_factor=8.0,
                     router_aux=s.moe.router_aux)
    return LayerCfg(mixer=s.mixer, attn=_shrink_attn(s.attn, d), mamba=mam,
                    ffn=s.ffn, d_ff=2 * d if s.ffn == "dense" else 0, moe=moe)


def reduced(cfg: ArchConfig, d_model: int = 64, max_slots: int = 2) -> ArchConfig:
    """≤2-layer, tiny-width smoke variant with the same layer types."""
    slots = [s for g in cfg.groups for s in g.slots]
    if len(slots) > max_slots:
        seen: dict[tuple, LayerCfg] = {}
        for s in slots:
            seen.setdefault((s.mixer, s.ffn), s)
        slots = list(seen.values())[:max_slots]
    slots = [_shrink_slot(s, d_model) for s in slots]
    fe = None
    if cfg.frontend is not None:
        fe = dataclasses.replace(cfg.frontend, n_embeds=8, embed_dim=32)
    return dataclasses.replace(
        cfg, name=cfg.name + "-reduced", d_model=d_model, vocab=256,
        groups=(Group(tuple(slots), 1),), frontend=fe, max_seq=128)
