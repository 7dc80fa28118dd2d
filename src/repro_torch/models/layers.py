"""Layers of the decoder, perturbation-aware (the dense, MoE, MLA and
Mamba-1 subset of ``repro/models/layers.py``: rmsnorm and layernorm, silu,
gelu and relu, gated and plain MLPs, rope and the sinusoidal position
table, global and sliding-window
attention, DeepSeek-V2's multi-head latent attention, and attention's
decode halves).

Activations carry a leading client axis: ``x (C, B, T, D)``.  A decode
cache serves one model (C = 1) and carries no client axis: each attention
layer owns ``{"k": (B, Cap, KV, hd), "v": ..., "kpos": (Cap,) int64}``, a
ring addressed by ``pos % Cap`` whose ``kpos`` records the absolute
position a slot holds (-1: empty), or one layer of the paged pool,
``{"k": (P + 1, page, KV, hd), "v": ...}`` with the dump page last.  An
MLA layer owns the compressed ring ``{"ckv": (B, Cap, kv_lora), "krope":
(B, Cap, rd), "kpos": (Cap,)}`` and decodes in the absorbed formulation.
All are written in place (the JAX package's donated buffers).  Attention
(MLA's expansion and absorption included), routing, dispatch and combine,
the causal conv and the SSM's gates are plain PyTorch, as the JAX package
computes them outside any Pallas kernel; the perturbed projections go
through ``Bundle.dense`` and ``Bundle.expert_dense`` (the fused kernels),
the Mamba recurrence through ``kernels.ops.selective_scan``.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttnCfg, MambaCfg, MoECfg
from repro_torch.kernels import ops as kops
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


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5):
    """Mean and variance in float32, ``(1 + scale)`` and ``+ bias``, cast
    back to x.dtype.  ``scale`` and ``bias`` are per client (C, D)."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    d = x32 - mu
    var = torch.mean(d * d, dim=-1, keepdim=True)
    out = d * torch.rsqrt(var + eps)
    out = out * (1.0 + _per_client(scale, x.ndim).float()) \
        + _per_client(bias, x.ndim).float()
    return out.to(x.dtype)


def norm(b: Bundle, key: str, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "layernorm":
        return layernorm(x, b.vec(key + "_scale"), b.vec(key + "_bias"))
    return rmsnorm(x, b.vec(key + "_scale"))


#: ``jax.nn.gelu`` defaults to the tanh approximation, and so does the port
#: (the erf form is another function)
ACTS = {"silu": F.silu, "gelu": functools.partial(F.gelu, approximate="tanh"),
        "relu": F.relu}


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding.  x (..., T, H, hd), positions (T,) or, for the
    paged decode, per-request (B, T) (the cos/sin tables broadcast over the
    head axis either way)."""
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


def sinusoidal_pos(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """The sinusoidal position table, float32 and unclipped: (..., dim) for
    positions (...,), sines in the first half, cosines in the second."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
              window: int | None) -> torch.Tensor:
    """(T, S) boolean causal mask, optionally sliding-window (a query at q
    sees keys q - window < k <= q); k_pos = -1 marks an empty slot.  With
    per-request positions (B, T) / (B, S) it is (B, T, S)."""
    m = (k_pos[..., None, :] <= q_pos[..., :, None]) \
        & (k_pos[..., None, :] >= 0)
    if window is not None:
        m &= k_pos[..., None, :] > q_pos[..., :, None] - window
    return m


def attn_core(q, k, v, q_pos, k_pos, window: int | None):
    """Grouped-query attention.  q (C,B,T,H,hd), k/v (C,B,S,KV,hd)
    -> (C,B,T,H*hd).  Positions are shared (T,)/(S,) or per-request
    (B,T)/(B,S); ``window`` None is global attention."""
    C, B, T, H, hd = q.shape
    KV = k.shape[3]
    G = H // KV
    qg = q.reshape(C, B, T, KV, G, hd)
    logits = torch.einsum("cbtkgd,cbskd->cbkgts", qg, k).float()
    logits = logits * (1.0 / math.sqrt(hd))
    mask = attn_mask(q_pos, k_pos, window)
    if mask.ndim == 3:
        mask = mask[None, :, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("cbkgts,cbskd->cbtkgd", probs, v)
    return out.reshape(C, B, T, H * hd)


def _ring_write(cache: dict, pos: int, **new: torch.Tensor) -> None:
    """Write T new entries per named buffer (``k=``, ``v=`` (B, T, KV,
    hd); MLA's ``ckv=``, ``krope=`` (B, T, width)) ending at absolute
    position pos + T - 1 into a ring cache of capacity Cap, in place (a
    full cache is a ring with Cap >= seq); a prefill longer than the ring
    keeps its last Cap positions."""
    cap = cache["kpos"].shape[0]
    T = next(iter(new.values())).shape[1]
    keep = max(0, T - cap)
    new_pos = pos + torch.arange(keep, T, device=cache["kpos"].device)
    slots = new_pos % cap
    for name, t in new.items():
        cache[name][:, slots] = t[:, keep:].to(cache[name].dtype)
    cache["kpos"][slots] = new_pos


def _qkv(b: Bundle, x: torch.Tensor, acfg: AttnCfg):
    C, B, T, _ = x.shape
    H, KV, hd = acfg.n_heads, acfg.n_kv_heads, acfg.head_dim
    bias = acfg.qkv_bias
    q = b.dense("wq", x, bias="bq" if bias else None).reshape(C, B, T, H, hd)
    k = b.dense("wk", x, bias="bk" if bias else None).reshape(C, B, T, KV, hd)
    v = b.dense("wv", x, bias="bv" if bias else None).reshape(C, B, T, KV, hd)
    return q, k, v


def _one_model(x: torch.Tensor) -> None:
    if x.shape[0] != 1:
        raise ValueError(f"a decode cache serves one model (client axis 1), "
                         f"got {x.shape[0]}")


def attention(b: Bundle, x: torch.Tensor, acfg: AttnCfg, rope_theta: float,
              pos_kind: str = "rope", pos: int = 0,
              cache: dict | None = None):
    """Standard (GQA) attention; rope only for ``pos_kind == "rope"``
    (learned positions are added to the embeddings).  ``pos`` is the
    absolute position of x[:, :, 0].  Without a cache it is the training
    forward; with one (one model) the new k/v are written into the ring
    and a decode step (T == 1) attends the ring, while a prefill (T > 1)
    attends its own raw k/v, as the JAX package's (a windowed ring may
    already have evicted the prompt's early positions)."""
    T = x.shape[2]
    q, k, v = _qkv(b, x, acfg)
    q_pos = pos + torch.arange(T, device=x.device)
    if pos_kind == "rope":
        q = rope(q, q_pos, rope_theta)
        k = rope(k, q_pos, rope_theta)
    if cache is not None:
        _one_model(x)
        _ring_write(cache, pos, k=k[0], v=v[0])
    if cache is None or T > 1:
        out = attn_core(q, k, v, q_pos, q_pos, acfg.window)
    else:
        out = attn_core(q, cache["k"][None], cache["v"][None], q_pos,
                        cache["kpos"], acfg.window)
    return b.dense("wo", out)


def paged_attention(b: Bundle, x: torch.Tensor, acfg: AttnCfg,
                    rope_theta: float, pos_kind: str, pos_b: torch.Tensor,
                    pages: dict, table: torch.Tensor):
    """Decode-only (T == 1) GQA attention of one model over one layer of
    the paged KV pool, ``pages`` ``{"k": (P + 1, page, KV, hd), "v": ...}``
    with the dump page last.  ``table`` (B, Pb) holds each request slot's
    physical pages in logical order (unreserved entries: the dump page);
    ``pos_b`` (B,) the absolute position of each slot's incoming token.

    The new k/v are scattered into the pool in place (inactive slots all
    write the dump page, which no live request attends with nonzero
    probability), then each slot gathers its Pb pages: S = Pb·page
    positions, those past ``pos_b`` (and, in a sliding-window slot, those
    at or before ``pos_b - window``) masked to probability exactly 0."""
    _, B, T, _ = x.shape
    if T != 1:
        raise ValueError(f"paged_attention is decode-only (got T={T}; "
                         "prefill goes through the monolithic path and is "
                         "scattered into pages afterwards)")
    _one_model(x)
    q, k, v = _qkv(b, x, acfg)
    q_pos = pos_b[:, None]                                     # (B, 1)
    if pos_kind == "rope":
        q = rope(q, q_pos, rope_theta)
        k = rope(k, q_pos, rope_theta)
    page = pages["k"].shape[1]
    Pb = table.shape[1]
    phys = torch.gather(table, 1, (pos_b // page)[:, None])[:, 0]
    off = pos_b % page
    pages["k"][phys, off] = k[0, :, 0].to(pages["k"].dtype)
    pages["v"][phys, off] = v[0, :, 0].to(pages["v"].dtype)
    S = Pb * page
    kv_shape = (1, B, S) + tuple(pages["k"].shape[2:])
    kg = pages["k"][table].reshape(kv_shape)
    vg = pages["v"][table].reshape(kv_shape)
    s_iota = torch.arange(S, device=x.device)[None, :]
    k_pos = torch.where(s_iota <= pos_b[:, None], s_iota,
                        torch.full_like(s_iota, -1))            # (B, S)
    out = attn_core(q, kg, vg, q_pos, k_pos, acfg.window)
    return b.dense("wo", out)


def _mla_dims(acfg: AttnCfg):
    """(nope, rd, vd): the per-head widths of MLA's non-rope query / key
    part, its decoupled rope part and its values."""
    return acfg.head_dim, acfg.rope_head_dim, \
        acfg.v_head_dim or acfg.head_dim


def mla_attention(b: Bundle, x: torch.Tensor, acfg: AttnCfg,
                  rope_theta: float, pos: int = 0,
                  cache: dict | None = None):
    """Multi-head latent attention (DeepSeek-V2): queries through a
    low-rank ``wdq`` / rmsnorm / ``wuq`` (or one ``wq`` when q_lora is 0),
    keys and values from a joint compressed ``ckv`` (kv_lora wide, after
    an rmsnorm) expanded by ``wukv``, plus a decoupled rope key shared by
    every head.  x (C, B, T, D) -> (C, B, T, D).

    Training and prefill expand ``ckv`` into per-head keys and values; a
    prefill also writes ``ckv`` and the roped ``krope`` into the compressed
    ring (one model).  A decode step (T == 1 with a cache) writes its entry
    and runs the absorbed formulation: ``q_nope · W_uk`` against the cached
    ``ckv``, plus ``q_rope · krope``, softmax, then ``· ckv · W_uv``, so it
    never expands the cache.  The nope and rope logits are summed before
    the float32 cast and the ``1/sqrt(nope + rd)`` scale, as the JAX
    package's.

    ``wukv`` is read as stored (``Bundle.raw``), as the JAX package reads
    it through ``b.p``: its SubCGE perturbation never reaches the loss,
    though the update still moves it (kept for parity, ROADMAP Queue 3).
    Every other projection goes through ``Bundle.dense``."""
    C, B, T, _ = x.shape
    H = acfg.n_heads
    nope, rd, vd = _mla_dims(acfg)
    q_pos = pos + torch.arange(T, device=x.device)

    if acfg.q_lora > 0:
        cq = rmsnorm(b.dense("wdq", x), b.vec("q_ln_scale"))
        q = b.dense("wuq", cq).reshape(C, B, T, H, nope + rd)
    else:
        q = b.dense("wq", x).reshape(C, B, T, H, nope + rd)
    q_nope = q[..., :nope]
    q_rope = rope(q[..., nope:], q_pos, rope_theta)

    dkv = b.dense("wdkv", x)                        # (C,B,T,kv_lora + rd)
    ckv_new = rmsnorm(dkv[..., :acfg.kv_lora], b.vec("kv_ln_scale"))
    # the rope key: one head, shared by all H
    krope_new = rope(dkv[..., None, acfg.kv_lora:], q_pos,
                     rope_theta)[..., 0, :]

    wukv = b.raw("wukv").reshape(C, acfg.kv_lora, H, nope + vd)
    scale = 1.0 / math.sqrt(nope + rd)

    if cache is not None:
        _one_model(x)
        _ring_write(cache, pos, ckv=ckv_new[0], krope=krope_new[0])
    if cache is not None and T == 1:
        ckv, krope = cache["ckv"][None], cache["krope"][None]
        q_abs = torch.einsum("cbthn,clhn->cbthl", q_nope,
                             wukv[..., :nope])          # (C,B,1,H,kv_lora)
        lg = torch.einsum("cbthl,cbsl->cbhts", q_abs, ckv)
        lg = lg + torch.einsum("cbthr,cbsr->cbhts", q_rope, krope)
        lg = lg.float() * scale
        mask = attn_mask(q_pos, cache["kpos"], acfg.window)
        lg = torch.where(mask, lg, torch.full_like(lg, _NEG_INF))
        probs = torch.softmax(lg, dim=-1).to(ckv.dtype)
        out_c = torch.einsum("cbhts,cbsl->cbthl", probs, ckv)
        out = torch.einsum("cbthl,clhv->cbthv", out_c, wukv[..., nope:])
        return b.dense("wo", out.reshape(C, B, T, H * vd))

    kv = torch.einsum("cbtl,clhe->cbthe", ckv_new, wukv)  # (C,B,T,H,nope+vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    lg = torch.einsum("cbthn,cbshn->cbhts", q_nope, k_nope)
    lg = lg + torch.einsum("cbthr,cbsr->cbhts", q_rope, krope_new)
    lg = lg.float() * scale
    mask = attn_mask(q_pos, q_pos, acfg.window)
    lg = torch.where(mask, lg, torch.full_like(lg, _NEG_INF))
    probs = torch.softmax(lg, dim=-1).to(v.dtype)
    out = torch.einsum("cbhts,cbshv->cbthv", probs, v)
    return b.dense("wo", out.reshape(C, B, T, H * vd))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 tail: torch.Tensor | None = None):
    """Depthwise causal conv1d per client.  x (C, B, T, Di), w (C, Di, Kc),
    bias (C, Di).  The Kc − 1 steps before x are ``tail`` (C, B, Kc − 1,
    Di, of x's dtype), zeros when it is None.  The Kc shifted products are
    summed in the JAX order (``F.conv1d`` sums in another)."""
    T, Kc = x.shape[2], w.shape[-1]
    xp = F.pad(x, (0, 0, Kc - 1, 0)) if tail is None \
        else torch.cat([tail, x], dim=2)
    out = sum(xp[:, :, k:k + T] * _per_client(w[..., k], x.ndim)
              for k in range(Kc))
    return out + _per_client(bias, x.ndim)


def mamba(b: Bundle, x: torch.Tensor, mcfg: MambaCfg,
          cache: dict | None = None) -> torch.Tensor:
    """Mamba-1 block.  x (C, B, T, D) -> (C, B, T, D).  The clients fold
    into the scan's batch axis; ``a`` and ``bx`` (C·B, T, Di, N) float32 are
    freed before ``out_proj``.

    Without ``cache`` (training): h0 = 0 and the conv pads with zeros.
    With ``cache`` (one model, C = 1: this layer's {"h": (B, Di, N)
    float32, "conv": (B, Kc − 1, Di)}, written in place), T > 1 is a
    prefill and T = 1 a decode step, both through the same scan launch:
    the scan starts from ``h`` and ends in it, the conv reads ``conv`` as
    the Kc − 1 steps before x and keeps the last Kc − 1 of the two.  On a
    fresh (zero) cache that is bitwise the JAX ``mamba``'s prefill, which
    pads with zeros; unlike it, a prefill onto a live cache continues the
    conv window, and a prompt shorter than Kc − 1 leaves a whole window
    (ROADMAP Queue 3).  At T = 1 it is the JAX step's formula, ``a·h + bx``
    and its readout."""
    C, B, T, D = x.shape
    Di, N = mcfg.d_inner, mcfg.d_state
    dtr = mcfg.dt_rank or -(-D // 16)

    xz = b.dense("in_proj", x)                            # (C,B,T,2Di)
    xin, z = torch.split(xz, Di, dim=-1)
    tail = None if cache is None else cache["conv"][None].to(xin.dtype)
    xc = F.silu(_causal_conv(xin, b.matw("conv_w"), b.vec("conv_b"), tail))
    if cache is not None:
        cache["conv"].copy_(torch.cat([tail, xin], dim=2)[0, :, T:])

    xdb = b.dense("x_proj", xc)                           # (C,B,T,dtr+2N)
    dt_in, B_in, C_in = torch.split(xdb, [dtr, N, N], dim=-1)
    dt = b.dense("dt_proj", dt_in) + _per_client(b.vec("dt_bias"), x.ndim)
    # jax.nn.softplus: logaddexp(x, 0), with no threshold (F.softplus
    # switches to x above 20)
    dt = torch.logaddexp(dt, torch.zeros_like(dt))
    A = -torch.exp(b.matw("A_log").float())               # (C,Di,N)

    a = (dt.float()[..., None] * A[:, None, None]).exp_()
    bx = (dt * xc).float()[..., None] * B_in.float()[..., None, :]
    h0 = torch.zeros((C * B, Di, N), dtype=torch.float32, device=x.device) \
        if cache is None else cache["h"]
    y, h_last = kops.selective_scan(
        a.reshape(C * B, T, Di, N), bx.reshape(C * B, T, Di, N),
        C_in.float().reshape(C * B, T, N).contiguous(), h0)
    del a, bx, h0
    if cache is not None:
        cache["h"].copy_(h_last)

    y = y.reshape(C, B, T, Di).to(x.dtype) \
        + _per_client(b.vec("D_skip"), x.ndim).to(x.dtype) * xc
    y = y * F.silu(z)
    return b.dense("out_proj", y)


def mlp(b: Bundle, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    """Dense MLP: ``act(x W1) * x W3`` when gated, else ``act(x W1)``,
    then ``W2``."""
    f = ACTS[act]
    if gated:
        h = f(b.dense("w1", x)) * b.dense("w3", x)
    else:
        h = f(b.dense("w1", x))
    return b.dense("w2", h)


def _dispatch_indices(idx: torch.Tensor, n_experts: int, capacity: int):
    """Position of every (token, slot) assignment inside its expert's buffer.
    idx (C, T, k) -> pos (C, T, k) int64 and keep-mask (pos < capacity).
    Slot-major and sequential over the k slots, as the JAX ``lax.scan``:
    which assignments a full expert drops is exactly the JAX package's."""
    C, T, K = idx.shape
    counts = torch.zeros((C, 1, n_experts), dtype=torch.int64,
                         device=idx.device)
    pos = []
    for s in range(K):
        oh = F.one_hot(idx[..., s].long(), n_experts)                # (C,T,E)
        pos_all = counts + torch.cumsum(oh, dim=1) - oh
        pos.append(torch.gather(pos_all, 2, idx[..., s, None].long())[..., 0])
        counts = counts + oh.sum(dim=1, keepdim=True)
    pos = torch.stack(pos, dim=-1)
    return pos, pos < capacity


def route(b: Bundle, xt: torch.Tensor, mcfg: MoECfg):
    """Router of :func:`moe`: xt (C, T, D) -> probs (C, T, E) float32 and
    the renormalised top-k (top_p, top_i), each (C, T, k), best first."""
    probs = torch.softmax(b.dense("router", xt).float(), dim=-1)
    top_p, top_i = torch.topk(probs, mcfg.top_k, dim=-1, sorted=True)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_i


def moe(b: Bundle, x: torch.Tensor, mcfg: MoECfg):
    """Top-k capacity-dispatch MoE with gated SiLU experts, per client.
    x (C, B, T, D) -> (y (C, B, T, D), aux (C,)).

    Deterministic on the card: dispatch records each kept assignment's
    token in its own slot (dropped ones share a dump slot that is never
    read) and gathers the slots' rows; the combine gathers each token's kept
    slots and sums them in ascending expert order from 0.0 — the order of
    the JAX scatter-add over slot index ``e * capacity + pos``.  No atomics.
    """
    C, B, T, D = x.shape
    E, K = mcfg.n_experts, mcfg.top_k
    n_tok = B * T
    xt = x.reshape(C, n_tok, D)
    probs, top_p, top_i = route(b, xt, mcfg)
    capacity = max(1, int(math.ceil(n_tok * K / E * mcfg.capacity_factor)))
    pos, keep = _dispatch_indices(top_i, E, capacity)
    dest = torch.where(keep, top_i * capacity + pos,
                       torch.full_like(pos, E * capacity))          # (C,T,k)
    # dispatch as a gather: each slot's token (n_tok, a zero row, if empty);
    # every kept assignment owns its slot, dropped ones share the dump slot
    cidx = torch.arange(C, device=x.device)[:, None]
    slot_tok = torch.full((C, E * capacity + 1), n_tok, dtype=torch.int64,
                          device=x.device)
    tok = torch.arange(n_tok, device=x.device).repeat_interleave(K)
    slot_tok[cidx, dest.reshape(C, -1)] = tok.expand(C, -1)
    xz = torch.cat([xt, xt.new_zeros((C, 1, D))], dim=1)
    xe = xz[cidx, slot_tok[:, :E * capacity]].reshape(C, E, capacity, D)

    h = F.silu(b.expert_dense("w1", xe)) * b.expert_dense("w3", xe)
    ye = b.expert_dense("w2", h).reshape(C, E * capacity, D)

    # combine: each token's kept slots, in ascending expert order
    order = torch.argsort(top_i, dim=-1)
    kept = torch.gather(keep, 2, order)                             # (C,T,k)
    src = torch.gather(dest, 2, order).clamp(max=E * capacity - 1)
    w = torch.gather(top_p, 2, order).to(ye.dtype)
    part = ye[cidx, src.reshape(C, -1)].reshape(C, n_tok, K, D) * w[..., None]
    y = torch.zeros((C, n_tok, D), dtype=ye.dtype, device=x.device)
    for s in range(K):
        y = torch.where(kept[..., s, None], y + part[:, :, s], y)

    if mcfg.n_shared > 0:
        hs = F.silu(b.dense("sw1", xt)) * b.dense("sw3", xt)
        y = y + b.dense("sw2", hs)

    # load-balance auxiliary (Switch-style): E * sum_e f_e * mean p_e
    me = F.one_hot(top_i[..., 0], E).float().mean(dim=1)
    ce = probs.mean(dim=1)
    aux = mcfg.router_aux * E * (me * ce).sum(dim=-1)
    return y.reshape(C, B, T, D), aux
