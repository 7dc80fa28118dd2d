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
too: the port has no mesh.  ``InputShape`` and ``INPUT_SHAPES`` are the
pod's input shapes, and ``ArchConfig.for_shape`` the variant an arch runs
at one of them (``long_context_mode``: a full-attention arch decodes past
100,000 positions through sliding windows of ``sliding_window_size``);
``roofline.cost_model.step_cost`` prices an arch at a shape.
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
    # long_500k handling: "native" (sub-quadratic already) or "sliding_window"
    # (the variant a full-attention arch decodes that far with)
    long_context_mode: str = "sliding_window"
    sliding_window_size: int = 4096
    source: str = ""                   # citation [arXiv:... / hf:...]

    @property
    def n_layers(self) -> int:
        return sum(len(g.slots) * g.reps for g in self.groups)

    def layer_cfgs(self) -> list[LayerCfg]:
        """Every layer's slot, in stack order."""
        out: list[LayerCfg] = []
        for g in self.groups:
            out.extend(list(g.slots) * g.reps)
        return out

    def with_sliding_window(self, window: int) -> "ArchConfig":
        """Long-context variant: every attention slot's window clamped to
        ``window`` (a global slot takes it)."""
        def clamp(slot: LayerCfg) -> LayerCfg:
            if slot.mixer != "attn" or slot.attn is None:
                return slot
            w = slot.attn.window
            new_w = window if w is None else min(w, window)
            return dataclasses.replace(
                slot, attn=dataclasses.replace(slot.attn, window=new_w))

        groups = tuple(dataclasses.replace(
            g, slots=tuple(clamp(s) for s in g.slots)) for g in self.groups)
        return dataclasses.replace(self, groups=groups,
                                   name=self.name + "+sw" + str(window))

    def for_shape(self, shape: "InputShape") -> "ArchConfig":
        """The arch variant that runs at ``shape``: a decode past 100,000
        positions takes sliding windows unless the arch is native there."""
        if (shape.kind == "decode" and shape.seq > 100_000
                and self.long_context_mode == "sliding_window"):
            return self.with_sliding_window(self.sliding_window_size)
        return self


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq: int
    global_batch: int
    kind: str                          # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


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
