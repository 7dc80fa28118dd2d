"""Architecture configuration dataclasses (the dense subset).

The counterpart of ``repro/configs/base.py`` for the layer types the port
runs so far: attention (GQA, optional QKV bias) and a dense MLP, stacked as
groups of repeating slots.  Fields the port cannot run yet are kept out
rather than silently ignored; ``models.transformer.arch_spec`` rejects
settings outside rmsnorm / silu / gated MLP / rope / tied embeddings.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False


@dataclasses.dataclass(frozen=True)
class LayerCfg:
    mixer: str = "attn"                # "attn"
    attn: AttnCfg | None = None
    ffn: str = "dense"                 # "dense"
    d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class Group:
    slots: tuple[LayerCfg, ...]
    reps: int


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                        # dense
    d_model: int
    vocab: int
    groups: tuple[Group, ...]
    norm: str = "rmsnorm"
    act: str = "silu"
    gated_mlp: bool = True
    pos: str = "rope"
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    max_seq: int = 131_072
    source: str = ""                   # citation [arXiv:... / hf:...]

    @property
    def n_layers(self) -> int:
        return sum(len(g.slots) * g.reps for g in self.groups)


def dense_layer(d_model: int, n_heads: int, n_kv: int, d_ff: int,
                head_dim: int | None = None, qkv_bias: bool = False) -> LayerCfg:
    hd = head_dim if head_dim is not None else d_model // n_heads
    return LayerCfg(mixer="attn", attn=AttnCfg(n_heads, n_kv, hd, qkv_bias),
                    ffn="dense", d_ff=d_ff)


def uniform_dense(name: str, *, n_layers: int, d_model: int, n_heads: int,
                  n_kv: int, d_ff: int, vocab: int, head_dim: int | None = None,
                  qkv_bias: bool = False, **kw) -> ArchConfig:
    slot = dense_layer(d_model, n_heads, n_kv, d_ff, head_dim, qkv_bias)
    return ArchConfig(name=name, family="dense", d_model=d_model, vocab=vocab,
                      groups=(Group((slot,), n_layers),), **kw)
