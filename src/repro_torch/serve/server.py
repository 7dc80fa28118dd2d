"""Continuous-batching decode server over live seed-reconstructed weights
(the port of ``repro/serve/server.py``).

One :class:`DecodeServer` owns one model's weights, a paged KV pool and a
:class:`~repro_torch.serve.scheduler.Scheduler`.  Each :meth:`step` is one
decode-step boundary:

    1. fold   — buffered flood messages fold into the weights, in place
                (LiveUpdateBridge: one ``subcge_apply_epochs`` launch per
                matrix leaf)
    2. admit  — queued requests claim slots and pages; one prefill per
                distinct prompt length scatters their KV into the pool
    3. decode — one paged decode step at the current page bucket emits a
                token for every active slot
    4. evict  — finished slots free their pages back to the queue

The weights are the caller's unstacked flat tree, viewed with a client axis
of 1 (``t.unsqueeze(0)``, no copy) for the port's stacked forward; the fold
writes them in place, so a tree is never shared between servers.  The
server runs where its weights are: ``device`` (default ``"cuda"``) must be
available and hold every weight.  Sampling draws every active slot's token
in one call and brings them to the host once per step; temperature
sampling keys each token by (``sample_seed``, rid, emit position), as the
JAX server does.  Weights, the KV pool and the logits are in
``ServeConfig.param_dtype`` (float32 or bf16); bf16 logits sample through
bf16 Gumbels, as ``jax.random.categorical`` draws them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.launch import steps as steplib
from repro_torch.models import transformer as tf
from repro_torch.serve.bridge import LiveUpdateBridge
from repro_torch.serve.scheduler import Request, Scheduler, ServeConfig

#: Steps :meth:`DecodeServer.run` takes before it calls the loop stuck.
MAX_STEPS = 10_000


def resolve_device(device) -> torch.device:
    """The device a server runs on; raises when it is a card that this
    process cannot see (no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: serve on the card, or pass "
                               "device='cpu' explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def sample(logits: torch.Tensor, serve: ServeConfig, rids,
           emit_pos) -> list[int]:
    """Tokens for rows of logits (n, vocab), one host transfer.
    ``emit_pos`` is the absolute position each sampled token will occupy —
    (rid, emit_pos) keys its PRNG stream, so a run is deterministic and
    churn-replayable."""
    if serve.sampling == "greedy":
        return torch.argmax(logits, dim=-1).tolist()
    dev = logits.device

    def ids(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)
    key = prng.fold_in(prng.fold_in(prng.PRNGKey(serve.sample_seed, dev),
                                    ids(rids)), ids(emit_pos))
    # JAX divides by the temperature rounded to the logits' type.  A 0-dim
    # tensor on their device: CUDA multiplies by the reciprocal of a host
    # scalar, which can round differently
    temp = torch.tensor(prng.rounded(serve.temperature, logits.dtype),
                        dtype=logits.dtype, device=dev)
    return prng.categorical(key, logits / temp).tolist()


class DecodeServer:
    """Continuous-batching token server for one (possibly churning) node."""

    def __init__(self, cfg, params: dict, serve: ServeConfig, *,
                 bridge: LiveUpdateBridge | None = None, device="cuda"):
        tf.check_paged_support(cfg)
        self.device = resolve_device(device)
        for path, t in params.items():
            if t.device != self.device or t.dtype != serve.param_dtype:
                raise ValueError(
                    f"{path}: {t.dtype} on {t.device}; the server runs "
                    f"{serve.param_dtype} on {self.device}")
        self.cfg = cfg
        self.serve = serve
        self.bridge = bridge
        self.params = params
        self._view = {p: t.unsqueeze(0) for p, t in params.items()}
        self.pool = tf.init_paged_pool(cfg, serve.n_pages, serve.page_size,
                                       serve.param_dtype, self.device)
        self._decode = steplib.build_paged_decode_step(cfg)
        self.sched = Scheduler(serve)
        self.results: dict[int, list[int]] = {}
        self.n_steps = 0
        self.n_prefills = 0
        self.n_decodes = 0
        self.n_suspends = 0

    # -- request intake -------------------------------------------------------

    def submit(self, req: Request) -> None:
        if req.rid in self.results:
            raise ValueError(f"duplicate request id {req.rid}")
        self.results[req.rid] = []
        self.sched.submit(req)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    # -- sampling -------------------------------------------------------------

    def _sample(self, logits: torch.Tensor, rids, emit_pos) -> list[int]:
        return sample(logits, self.serve, rids, emit_pos)

    # -- one decode-step boundary ---------------------------------------------

    def step(self) -> None:
        if self.sched.done:
            return
        self.n_steps += 1
        if self.bridge is not None and self.bridge.pending:
            self.bridge.fold(self.params)
        admitted = self.sched.admit()
        groups: dict[int, list[tuple[int, Request]]] = {}
        for slot, req in admitted:
            groups.setdefault(len(req.prompt), []).append((slot, req))
        for T in sorted(groups):
            self._prefill_group(T, groups[T])
        if self.sched.active_slots():
            self._decode_once()

    def _prefill_group(self, T: int, group: list[tuple[int, Request]]):
        tokens = np.stack([r.prompt for _, r in group])
        table = np.stack([self.sched.alloc.table[s] for s, _ in group])
        fn = steplib.build_paged_prefill_step(
            self.cfg, len(group), T, self.serve.page_size,
            self.serve.param_dtype)
        last, self.pool = fn(self._view, self.pool, self._tensor(tokens),
                             self._tensor(table))
        self.n_prefills += 1
        # prefill emits the token at position len(prompt) == slot.pos
        toks = self._sample(last, [r.rid for _, r in group],
                            [self.sched.slots[s].pos for s, _ in group])
        for (slot, req), tok in zip(group, toks):
            self.results[req.rid].append(tok)
            self.sched.record_emit(slot, tok)

    def _decode_once(self):
        tokens, pos, table = self.sched.decode_inputs()
        logits, self.pool = self._decode(self._view, self.pool,
                                         self._tensor(tokens),
                                         self._tensor(table),
                                         self._tensor(pos))
        self.n_decodes += 1
        active = self.sched.active_slots()
        slots = [self.sched.slots[i] for i in active]
        # the decode wrote position s.pos; its token lands at s.pos + 1
        toks = self._sample(logits[self._tensor(active)],
                            [s.req.rid for s in slots],
                            [s.pos + 1 for s in slots])
        for slot, s, tok in zip(active, slots, toks):
            self.results[s.req.rid].append(tok)
            if not self.sched.record_emit(slot, tok):
                self.sched.advance(slot)

    # -- churn ----------------------------------------------------------------

    def suspend(self) -> int:
        """Node leaves mid-decode: every in-flight request is captured from
        its slot and page table as a resume request — prompt = tokens
        written so far, budget = remaining — and re-queued at the FRONT in
        slot order; its pages return to the free list.  On rejoin the
        normal admit path re-reserves pages and a re-prefill of the
        accumulated sequence resumes decode (the weights catch up
        separately, through anti-entropy into the bridge)."""
        n = 0
        for slot in reversed(self.sched.active_slots()):
            s = self.sched.slots[slot]
            emitted = s.req.max_new - s.remaining
            out = self.results[s.req.rid]
            toks = np.asarray(out[len(out) - emitted:], np.int32)
            seq = np.concatenate([s.req.prompt, toks]) if emitted \
                else s.req.prompt
            self.sched.release_slot(slot)
            self.sched.queue.appendleft(
                Request(rid=s.req.rid, prompt=seq, max_new=s.remaining))
            n += 1
        self.n_suspends += n
        return n

    # -- run loop -------------------------------------------------------------

    def run(self) -> dict[int, list[int]]:
        steps = 0
        while not self.sched.done:
            if steps >= MAX_STEPS:
                raise RuntimeError(
                    f"serve loop still busy after {MAX_STEPS} steps "
                    f"({len(self.sched.queue)} queued, "
                    f"{len(self.sched.active_slots())} active)")
            self.step()
            steps += 1
        return self.results

    def stats(self) -> dict:
        out = {"steps": self.n_steps, "prefills": self.n_prefills,
               "decodes": self.n_decodes, "suspends": self.n_suspends,
               "evicted": self.sched.n_evicted,
               "queued": len(self.sched.queue),
               "active": len(self.sched.active_slots()),
               "emitted": sum(len(v) for v in self.results.values())}
        if self.bridge is not None:
            out["bridge"] = self.bridge.stats()
        return out
