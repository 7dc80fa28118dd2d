"""Architecture configuration dataclasses (the dense, MoE, MLA, Mamba-1,
hybrid and frontend subset).

The counterpart of ``repro/configs/base.py`` for the layer types the port
runs so far: a mixer (attention: GQA, optional QKV bias, global or
sliding-window, or DeepSeek-V2's multi-head latent attention; or Mamba-1)
followed by a dense MLP, a top-k capacity-dispatch MoE or, after Mamba, no
FFN, stacked as groups of repeating slots (Jamba's period mixes both
mixers), optionally behind a stubbed modality frontend (``FrontendCfg``:
precomputed frame or patch embeddings through one trained projector).
Fields the port cannot run yet are kept out rather than silently ignored;
``models.transformer.arch_spec`` takes rmsnorm or layernorm, silu, gelu
(tanh) or relu, a gated or plain MLP (the MoE's experts stay gated silu),
and rope, learned or sinusoidal positions (none only for an
attention-free stack), and refuses the rest: any other position kind, an
attention slot with no FFN.  The JAX package's
``sharding_policy`` and ``moe_gather_weights`` are mesh hints and stay out
too: the port has no mesh; so do ``long_context_mode`` and its
``for_shape`` rewrite, whose only consumers are the pod's input shapes and
dry runs (ROADMAP Queue 1 item 14b; the pod's bf16 parameters and buffer
mode, items 14c and 14a, are ported: ``launch.steps.PodConfig``).
``MambaCfg`` leaves out the JAX ``chunk``: it sizes the chunks of the
associative scan in jnp, a memory knob with no consumer here, where the
recurrence runs through the ``selective_scan`` kernel in one pass over
T.  ``ChurnConfig`` is the declarative churn spec of a decentralized
run.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    window: int | None = None          # None = global attention
    # MLA (DeepSeek-V2): active iff kv_lora > 0
    q_lora: int = 0
    kv_lora: int = 0
    rope_head_dim: int = 0             # decoupled RoPE dims (MLA)
    v_head_dim: int = 0                # MLA value head dim (0 -> head_dim)

    @property
    def is_mla(self) -> bool:
        return self.kv_lora > 0


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0                   # 0 -> ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0                  # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux: float = 0.0            # load-balance aux loss coefficient


@dataclasses.dataclass(frozen=True)
class LayerCfg:
    mixer: str = "attn"                # "attn" | "mamba"
    attn: AttnCfg | None = None
    mamba: MambaCfg | None = None
    ffn: str = "dense"                 # "dense" | "moe" | "none"
    d_ff: int = 0
    moe: MoECfg | None = None


@dataclasses.dataclass(frozen=True)
class Group:
    slots: tuple[LayerCfg, ...]
    reps: int


@dataclasses.dataclass(frozen=True)
class FrontendCfg:
    """Stubbed modality frontend: the caller supplies precomputed frame or
    patch embeddings (B, n_embeds, embed_dim); the model owns only the
    projector ``frontend/proj`` (embed_dim x d_model) and prepends its
    output to the token embeddings."""
    kind: str                          # "vision" | "audio_cond"
    n_embeds: int                      # patches / conditioning frames
    embed_dim: int                     # pre-projector dim (e.g. ViT width)
    source: str = ""


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    vocab: int
    groups: tuple[Group, ...]
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "silu"                  # silu | gelu | relu
    gated_mlp: bool = True
    pos: str = "rope"                  # rope | learned | sinusoidal | none
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    max_seq: int = 131_072
    frontend: FrontendCfg | None = None
    source: str = ""                   # citation [arXiv:... / hf:...]

    @property
    def n_layers(self) -> int:
        return sum(len(g.slots) * g.reps for g in self.groups)


def dense_layer(d_model: int, n_heads: int, n_kv: int, d_ff: int,
                head_dim: int | None = None, qkv_bias: bool = False,
                window: int | None = None) -> LayerCfg:
    hd = head_dim if head_dim is not None else d_model // n_heads
    return LayerCfg(mixer="attn",
                    attn=AttnCfg(n_heads, n_kv, hd, qkv_bias, window),
                    ffn="dense", d_ff=d_ff)


def uniform_dense(name: str, *, n_layers: int, d_model: int, n_heads: int,
                  n_kv: int, d_ff: int, vocab: int, head_dim: int | None = None,
                  qkv_bias: bool = False, **kw) -> ArchConfig:
    slot = dense_layer(d_model, n_heads, n_kv, d_ff, head_dim, qkv_bias)
    return ArchConfig(name=name, family="dense", d_model=d_model, vocab=vocab,
                      groups=(Group((slot,), n_layers),), **kw)


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    """Declarative churn spec for decentralized runs (the JAX package's
    ``ChurnConfig``).  ``repro_torch.topology.dynamic.ChurnSchedule.
    from_config`` resolves it into the event script; ``leave_at`` /
    ``rejoin_at`` double as down/up (link_flap) and at/heal (partition)
    steps."""
    kind: str = "leave_rejoin"         # leave_rejoin | link_flap | partition | random
    nodes: tuple[int, ...] = ()        # leave_rejoin
    leave_at: int = 0
    rejoin_at: int = 0
    edges: tuple[tuple[int, int], ...] = ()          # link_flap
    groups: tuple[tuple[int, ...], ...] = ()         # partition
    n: int = 0                         # random: client count
    steps: int = 0                     # random: horizon
    rate: float = 0.0                  # random: per-step leave probability
    seed: int = 0
    outage: tuple[int, int] = (5, 15)  # random: offline duration range
    max_concurrent: int = 1            # random: max simultaneous departures
