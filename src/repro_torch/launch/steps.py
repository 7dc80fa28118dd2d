"""The pod runtime's steps (``repro/launch/steps.py``) on one card.

Plain functions on tensors of ONE model: no mesh, no shardings, no jit.

Training.  ``build_seedflood_train_step`` is the paper's Algorithm 1 as
the pod runs it: the n logical clients share one copy of the weights,
viewed with a client stride of 0 (``t[None].expand(n, ...)``, no copy), so
every client's ±ε forward is one batched forward whose perturbed
projections run ``rank1_matmul`` over that one W.  In fold mode the n
seed–scalar messages, with coefficients −lr/n · α, fold into the weights
by one ``subcge.apply_messages`` (``subcge_apply``), in place.  In buffer
mode (the paper's App. A) the state is (params, A-buffers): the matrix
updates accumulate as float32 coordinates in the buffers, the forwards
read the effective weights W + U A V^T, the vector leaves take their
updates at once, and at each τ-refresh the buffers fold into W under the
previous step's subspace and are zeroed.  The flood's all-gather of
(seed, α) is the identity here: the n clients live on one card.
``build_dsgd_train_step`` is the gossip baseline's pod step: the mean of
the clients' first-order gradients (autograd, one client at a time, plain
products, in the parameters' type; summed in float32), then p − lr·ḡ, in
place.  A frontend arch's batch carries its stubbed embeddings in the
parameters' type (``train_inputs``, ``make_train_batch``): they reach the
loss through ``frontend/proj``.

``PodConfig`` keeps the fields these steps read: ``lr``, ``eps``,
``rank``, ``tau``, ``base_seed``, ``n_clients``, ``param_dtype`` (bf16 by
default, as the JAX pod's: the parameters and embeddings, through the
kernels' bf16 paths) and ``apply_mode`` (``"fold"`` or ``"buffer"``).
``remat_clients``, ``spmd_client_axis`` and ``kernel_backend`` are mesh
and backend knobs with no meaning here (the port dispatches by device).

Serving.  Each ``build_*`` function binds an architecture and a geometry
and returns a step that takes the unstacked parameters viewed with a
client axis of 1 (``{path: t[None]}``, no copy).  Caches and pools are
written in place and returned, as the JAX package's steps return theirs.
The monolithic steps serve every slot kind (attention, MLA, and Mamba
through its ``(h, conv)`` state, so hybrid and attention-free models too)
and frontend archs, whose prefill takes the embeddings; the paged steps
serve text over standard attention only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng, seeds as seedlib, subcge
from repro_torch.core.subcge import SubCGEConfig
from repro_torch.models import params as plib
from repro_torch.models import transformer as tf
from repro_torch.models.perturb import sample_pert


APPLY_MODES = ("fold", "buffer")


@dataclasses.dataclass(frozen=True)
class PodConfig:
    lr: float = 1e-5
    eps: float = 1e-3
    rank: int = 32
    tau: int = 1000
    base_seed: int = 0
    n_clients: int = 1             # logical clients sharing the one model
    param_dtype: torch.dtype = torch.bfloat16
    apply_mode: str = "fold"       # fold (UAV^T folded into W) | buffer

    def __post_init__(self):
        if self.apply_mode not in APPLY_MODES:
            raise ValueError(f"apply_mode must be one of {APPLY_MODES}, got "
                             f"{self.apply_mode!r}")

    def subcge(self) -> SubCGEConfig:
        return SubCGEConfig(rank=self.rank, refresh_period=self.tau,
                            eps=self.eps)


# ---------------------------------------------------------------------------
# training inputs
# ---------------------------------------------------------------------------

def train_inputs(cfg: ArchConfig, seq: int, global_batch: int,
                 pod: PodConfig) -> dict[str, tuple[int, ...]]:
    """Shapes of one training step's batch: ``global_batch`` sequences of
    ``seq`` positions split over the n clients, a frontend's P embeddings
    among the positions: {"tokens": (n, b, seq − P), "embeds": (n, b, P,
    edim)} (embeddings in ``pod.param_dtype``)."""
    n = pod.n_clients
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n} clients")
    b = global_batch // n
    fe = cfg.frontend
    out = {"tokens": (n, b, seq - (fe.n_embeds if fe else 0))}
    if fe is not None:
        out["embeds"] = (n, b, fe.n_embeds, fe.embed_dim)
    return out


def make_train_batch(cfg: ArchConfig, seq: int, global_batch: int,
                     pod: PodConfig, seed: int = 0, device="cpu") -> dict:
    """A batch of :func:`train_inputs`' shapes made from ``seed``: tokens
    uniform over the vocabulary, embeddings standard normal (the stubbed
    encoder's output, drawn in float32 and cast to ``pod.param_dtype``),
    both drawn on ``device``."""
    shapes = train_inputs(cfg, seq, global_batch, pod)
    kt, ke = prng.split(prng.PRNGKey(seed, device)).unbind(-2)
    out = {"tokens": prng.randint(kt, shapes["tokens"], 0, cfg.vocab).long()}
    if "embeds" in shapes:
        out["embeds"] = prng.normal(ke, shapes["embeds"]).to(pod.param_dtype)
    return out


# ---------------------------------------------------------------------------
# SeedFlood train step (fold and buffer modes)
# ---------------------------------------------------------------------------

def init_buffers(cfg: ArchConfig, pod: PodConfig, device="cpu") -> dict:
    """Buffer mode's zero float32 A-buffers of one model: {path: (1, *B, r,
    r)} for every matrix leaf."""
    return subcge.zero_buffers(plib.subcge_meta(tf.arch_spec(cfg)),
                               pod.subcge(), 1, device)


def build_seedflood_train_step(cfg: ArchConfig, pod: PodConfig):
    """step(state, batch, step) -> (state, metrics): one SeedFlood step of
    ``pod.n_clients`` clients over one model's flat parameters (updated in
    place).  The state is the parameters in fold mode, and (parameters,
    :func:`init_buffers`) in buffer mode.  ``batch`` is
    :func:`train_inputs`-shaped; ``metrics`` holds the mean loss, the RMS
    of the n coefficients α and the step."""
    meta = plib.subcge_meta(tf.arch_spec(cfg))
    scfg = pod.subcge()
    n = pod.n_clients
    buffer_mode = pod.apply_mode == "buffer"

    @torch.no_grad()
    def train_step(state, batch: dict, step: int):
        params, bufs = state if buffer_mode else (state, None)
        tokens = batch["tokens"]
        dev = tokens.device
        if tokens.shape[0] != n:
            raise ValueError(f"batch has {tokens.shape[0]} clients, the pod "
                             f"{n}")
        one = {p: t[None] for p, t in params.items()}
        if buffer_mode and step > 0 and step % scfg.refresh_period == 0:
            # a buffer is valid only under the subspace it accumulated
            # against: fold under the previous step's, then start afresh
            old = subcge.subspace_at_step(meta, scfg, pod.base_seed,
                                          step - 1, dev)
            subcge.fold_buffers(one, meta, old, bufs, inplace=True)
            bufs = {p: torch.zeros_like(b) for p, b in bufs.items()}
        sub = subcge.subspace_at_step(meta, scfg, pod.base_seed, step, dev)
        seeds = torch.as_tensor(
            seedlib.client_seeds(pod.base_seed, step, n).astype(np.int64),
            device=dev)
        pert = sample_pert(meta, scfg, seeds, pod.eps)
        eff = subcge.effective_params(one, meta, sub, bufs) if buffer_mode \
            else one
        # the one model seen by n clients: a client stride of 0, no copy
        view = {p: t.expand((n,) + tuple(t.shape[1:]))
                for p, t in eff.items()}
        embeds = batch.get("embeds")
        lp = tf.lm_loss(cfg, view, tokens, embeds=embeds, sub=sub, pert=pert)
        lm = tf.lm_loss(cfg, view, tokens, embeds=embeds, sub=sub,
                        pert=pert.with_scale(-pod.eps))
        del view, eff
        alphas = (lp - lm) / (2 * pod.eps)
        losses = 0.5 * (lp + lm)
        coefs = (-pod.lr / n) * alphas
        metrics = {"loss": losses.mean(),
                   "alpha_rms": torch.sqrt(torch.mean(alphas ** 2)),
                   "step": step}
        if buffer_mode:
            # O(n) coordinate updates; the vector leaves follow MeZO at once
            bufs = subcge.accumulate_buffers(bufs, meta, scfg, seeds[None],
                                             coefs[None])
            subcge.apply_vector_messages(one, meta, scfg, seeds[None],
                                         coefs[None])
            return (params, bufs), metrics
        subcge.apply_messages(one, meta, scfg, sub, seeds[None], coefs[None])
        return params, metrics
    return train_step


# ---------------------------------------------------------------------------
# DSGD pod step (the first-order baseline)
# ---------------------------------------------------------------------------

def build_dsgd_train_step(cfg: ArchConfig, pod: PodConfig):
    """step(params, batch, step) -> (params, metrics): each client's
    gradient of its ``lm_loss`` on its own batch (autograd through the
    plain products in the parameters' type, one client at a time so that
    one client's activations are held), their mean ḡ, then params ←
    params − lr·ḡ in place.  The clients' gradients are summed in float32
    and divided by n before one cast to each leaf's type, as the
    reference's ``jnp.mean`` over its vmapped gradients upcasts bf16."""
    def train_step(params: dict, batch: dict, step: int):
        tokens, embeds = batch["tokens"], batch.get("embeds")
        n = tokens.shape[0]
        names = list(params)
        leaves = [params[p].detach().requires_grad_(True) for p in names]
        total: dict[str, torch.Tensor] = {}
        losses = []
        for i in range(n):
            loss = tf.lm_loss(
                cfg, {p: t[None] for p, t in zip(names, leaves)},
                tokens[i:i + 1],
                embeds=None if embeds is None else embeds[i:i + 1])[0]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for p, g in zip(names, grads):
                if g is None:
                    continue
                if p in total:
                    total[p].add_(g)
                else:
                    total[p] = g.float()
            losses.append(loss.detach())
        with torch.no_grad():
            for p, g in total.items():
                t = params[p]
                t -= pod.lr * (g / n).to(t.dtype)
        return params, {"loss": torch.stack(losses).mean(), "step": step}
    return train_step


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

def build_prefill_step(cfg: ArchConfig, batch: int, seq: int, dtype=None):
    """Prefill ``batch`` prompts of T tokens into a fresh monolithic cache
    of capacity ``seq`` (an MLA slot's is the compressed one, ``ckv`` and
    ``krope``; a Mamba slot's is its state after the prompt, ``h`` and
    ``conv``): step(params, tokens (B, T), embeds=None) -> (last-position
    logits (B, vocab), cache).  The cache is in ``dtype``, by default the
    parameters' (float32 or bf16; a Mamba slot's ``h`` stays float32, as
    the JAX package keeps it), and so are the logits.  A frontend arch's
    prompt (T > 1) takes its embeddings (B, P, edim) ahead of the tokens,
    so positions 0..P+T-1 fill and ``seq`` counts P; its decode then
    starts at pos = P + T."""
    def prefill_step(params, tokens, embeds=None):
        if cfg.frontend is not None and tokens.shape[1] > 1 \
                and embeds is None:
            raise ValueError(f"{cfg.name}: a frontend arch's prefill takes "
                             "its embeddings")
        cache = tf.init_cache(cfg, batch, seq,
                              dtype or params["embed/tok"].dtype,
                              tokens.device)
        logits, _ = tf.forward(
            cfg, params, tokens[None], cache=cache, pos=0,
            embeds=None if embeds is None else embeds[None])
        return logits[0, :, -1], cache
    return prefill_step


def build_decode_step(cfg: ArchConfig):
    """One new token per sequence against a monolithic cache (an MLA slot
    decodes in the absorbed formulation over its compressed cache, a Mamba
    slot advances its state by one step):
    step(params, cache, tokens (B, 1), pos) -> (logits (B, vocab), cache).
    Tokens only: a frontend's embeddings entered with the prefill, so pos
    counts them."""
    def decode_step(params, cache, tokens, pos: int):
        logits, _ = tf.forward(cfg, params, tokens[None], cache=cache,
                               pos=pos)
        return logits[0, :, 0], cache
    return decode_step


def paged_geometry(seq: int, batch: int,
                   page_size: int) -> tuple[int, int, int]:
    """Paged-pool geometry (page_size, pages_per_req, n_pages) for ``batch``
    requests of ``seq`` positions: every request reserves its whole length
    (the JAX ``_paged_geometry`` with a page size given)."""
    pages_per_req = -(-seq // page_size)
    return page_size, pages_per_req, batch * pages_per_req


def build_paged_prefill_step(cfg: ArchConfig, batch: int, seq: int,
                             page_size: int, dtype=None):
    """Prefill ``batch`` same-length prompts against a throwaway monolithic
    cache of capacity == prompt length (a sliding-window slot's ring holds
    its last ``window`` positions) and scatter their KV into the pool rows
    ``table`` names, each ring slot to the page of the position it holds
    (``transformer.write_prefill_to_pages``, which unlike the JAX
    package's is right past the window): step(params, pool, tokens (Bg,
    T), table (Bg, pages_per_req)) -> (last-position logits (Bg, vocab),
    pool).  The logits are the monolithic prefill's (the T > 1 path
    attends the raw k/v, never the cache layout); the throwaway cache is in
    ``dtype``, by default the parameters'.  An MLA or Mamba slot is
    refused, as the JAX package refuses it."""
    tf.check_paged_support(cfg)
    prefill = build_prefill_step(cfg, batch, seq, dtype)

    def prefill_step(params, pool, tokens, table):
        last, cache = prefill(params, tokens)
        pool = tf.write_prefill_to_pages(cache, pool, table, page_size)
        return last, pool
    return prefill_step


def build_paged_decode_step(cfg: ArchConfig):
    """One token for every continuous-batching request slot against the
    paged pool: step(params, pool, tokens (B, 1), table (B, Pb), pos_b
    (B,)) -> (logits (B, vocab), pool).  The attended width is the table's
    (the scheduler's page bucket) times the page size."""
    tf.check_paged_support(cfg)

    def decode_step(params, pool, tokens, table, pos_b):
        logits, _ = tf.forward(cfg, params, tokens[None], cache=pool,
                               pos=pos_b, paged_table=table)
        return logits[0, :, 0], pool
    return decode_step
