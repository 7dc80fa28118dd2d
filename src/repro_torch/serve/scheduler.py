"""Continuous-batching request scheduler (the port of
``repro/serve/scheduler.py``).

Pure host-side logic — no device work, no clocks — so admission, eviction
and page accounting are unit-testable and a serve run is a deterministic
function of its request script.  The
:class:`~repro_torch.serve.server.DecodeServer` drives one
:class:`Scheduler` and turns its decisions into prefill and decode steps.

Policy (deliberately simple and fully pinned by tests):

* FIFO admission — requests admit in submission order into the lowest free
  slot, as long as the head of the queue can reserve its full page budget.
  The queue never reorders (no starvation, no nondeterminism).
* Eviction on completion — a slot frees its pages the step its request
  emits its last token; the pages immediately become available to the
  queue (free-list reuse).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.serve.paged_cache import PageAllocator, bucket_pages, \
    pages_needed

SAMPLING_KINDS = ("greedy", "temperature")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of one serving node (every field is consumed — SF004)."""
    max_batch: int = 8           # continuous-batching decode width (slots)
    page_size: int = 16          # tokens per KV page
    n_pages: int = 64            # pool size (excluding the dump page)
    max_seq: int = 128           # per-request position cap (prompt + new)
    sampling: str = "greedy"     # "greedy" | "temperature"
    temperature: float = 1.0     # temperature-sampling divisor
    sample_seed: int = 0         # PRNG root for temperature sampling
    param_dtype: Any = torch.float32   # weights and KV pool

    def __post_init__(self):
        if self.sampling not in SAMPLING_KINDS:
            raise ValueError(f"sampling must be one of {SAMPLING_KINDS}, "
                             f"got '{self.sampling}'")
        if self.max_seq % self.page_size != 0:
            raise ValueError(f"max_seq ({self.max_seq}) must be a multiple "
                             f"of page_size ({self.page_size})")
        if self.sampling == "temperature" and self.temperature <= 0:
            raise ValueError("temperature must be > 0")
        if self.param_dtype != torch.float32:
            raise ValueError(
                f"param_dtype {self.param_dtype}: the port serves float32 "
                "only; every kernel takes float32 (bf16 weights are ROADMAP "
                "Queue 2 item 3)")

    @property
    def pages_per_req(self) -> int:
        return self.max_seq // self.page_size


@dataclasses.dataclass
class Request:
    """One decode request.  ``rid`` must be unique per server."""
    rid: int
    prompt: np.ndarray            # (L,) int32 token ids
    max_new: int                  # tokens to emit (>= 1; first from prefill)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim != 1 or self.prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")


@dataclasses.dataclass
class _Slot:
    req: Request
    pos: int          # absolute position of the next token to be written
    remaining: int    # tokens still to emit
    last_tok: int     # last emitted token (next decode input)


class Scheduler:
    """Slot + page bookkeeping for one serving node."""

    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg
        self.alloc = PageAllocator(cfg.n_pages, cfg.page_size, cfg.max_batch,
                                   cfg.pages_per_req)
        self.slots: list[_Slot | None] = [None] * cfg.max_batch
        self.queue: deque[Request] = deque()
        self.n_evicted = 0

    # -- submission / admission ---------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new > self.cfg.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + max_new "
                f"({req.max_new}) exceeds max_seq ({self.cfg.max_seq})")
        self.queue.append(req)

    def admit(self) -> list[tuple[int, Request]]:
        """FIFO-admit queued requests into free slots while the head can
        reserve its full page budget.  Returns [(slot, request)] admitted."""
        admitted = []
        while self.queue:
            req = self.queue[0]
            need = pages_needed(len(req.prompt) + req.max_new,
                                self.cfg.page_size)
            slot = next((i for i, s in enumerate(self.slots) if s is None),
                        None)
            if slot is None or not self.alloc.can_alloc(need):
                break
            self.queue.popleft()
            self.alloc.alloc(slot, need)
            self.slots[slot] = _Slot(req=req, pos=len(req.prompt),
                                     remaining=req.max_new, last_tok=-1)
            admitted.append((slot, req))
        return admitted

    # -- decode-step views ---------------------------------------------------

    def active_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def decode_bucket(self) -> int:
        """Pages the decode gather must cover for the furthest-along active
        request (its write position pos is attended inclusively)."""
        need = max(pages_needed(s.pos + 1, self.cfg.page_size)
                   for s in self.slots if s is not None)
        return bucket_pages(need, self.cfg.pages_per_req)

    def decode_inputs(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(tokens (B,1), pos (B,), table (B, bucket)) for one decode step.
        Inactive slots feed token 0 at position 0 through dump-page table
        rows — their lane computes garbage nobody reads or stores."""
        B = self.cfg.max_batch
        tokens = np.zeros((B, 1), np.int32)
        pos = np.zeros((B,), np.int32)
        for i, s in enumerate(self.slots):
            if s is not None:
                tokens[i, 0] = s.last_tok
                pos[i] = s.pos
        table = self.alloc.table[:, :self.decode_bucket()]
        return tokens, pos, table

    # -- progression ---------------------------------------------------------

    def record_emit(self, slot: int, tok: int) -> bool:
        """Record one emitted token for ``slot``; evicts (and frees pages)
        when the request completes.  Returns True if the slot finished."""
        s = self.slots[slot]
        s.last_tok = tok
        s.remaining -= 1
        if s.remaining == 0:
            self.alloc.release(slot)
            self.slots[slot] = None
            self.n_evicted += 1
            return True
        return False

    def advance(self, slot: int) -> None:
        self.slots[slot].pos += 1

    def release_slot(self, slot: int) -> None:
        """Free a slot without completing it (suspension on node leave)."""
        self.alloc.release(slot)
        self.slots[slot] = None

    @property
    def done(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)
