"""The serving steps (the serving half of ``repro/launch/steps.py``).

Plain functions on tensors of one model: no mesh, no shardings, no jit.
Each ``build_*`` function binds an architecture and a geometry and returns
a step that takes the unstacked parameters viewed with a client axis of 1
(``{path: t[None]}``, no copy).  Caches and pools are written in place
and returned, as the JAX package's steps return theirs.  The monolithic
steps serve every slot kind (attention, MLA, and Mamba through its
``(h, conv)`` state, so hybrid and attention-free models too); the paged
steps serve standard attention only.  The train steps come with the pod
runtime (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf


def build_prefill_step(cfg: ArchConfig, batch: int, seq: int,
                       dtype=torch.float32):
    """Prefill ``batch`` prompts of T <= ``seq`` tokens into a fresh
    monolithic cache of capacity ``seq`` (an MLA slot's is the compressed
    one, ``ckv`` and ``krope``; a Mamba slot's is its state after the
    prompt, ``h`` and ``conv``): step(params, tokens (B, T)) ->
    (last-position logits (B, vocab), cache)."""
    def prefill_step(params, tokens):
        cache = tf.init_cache(cfg, batch, seq, dtype, tokens.device)
        logits, _ = tf.forward(cfg, params, tokens[None], cache=cache, pos=0)
        return logits[0, :, -1], cache
    return prefill_step


def build_decode_step(cfg: ArchConfig):
    """One new token per sequence against a monolithic cache (an MLA slot
    decodes in the absorbed formulation over its compressed cache, a Mamba
    slot advances its state by one step):
    step(params, cache, tokens (B, 1), pos) -> (logits (B, vocab), cache)."""
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
                             page_size: int, dtype=torch.float32):
    """Prefill ``batch`` same-length prompts against a throwaway monolithic
    cache of capacity == prompt length (a sliding-window slot's ring holds
    its last ``window`` positions) and scatter their KV into the pool rows
    ``table`` names, each ring slot to the page of the position it holds
    (``transformer.write_prefill_to_pages``, which unlike the JAX
    package's is right past the window): step(params, pool, tokens (Bg,
    T), table (Bg, pages_per_req)) -> (last-position logits (Bg, vocab),
    pool).  The logits are the monolithic prefill's (the T > 1 path
    attends the raw k/v, never the cache layout).  An MLA or Mamba slot is
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
