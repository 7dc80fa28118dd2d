"""Host-side paged KV-cache bookkeeping (a copy of the JAX package's
``repro/serve/paged_cache.py``; numpy only).

The device side is a per-attention-slot page pool
(:func:`repro_torch.models.transformer.init_paged_pool`) of ``n_pages + 1``
physical pages; this module owns the *logical* side: which physical pages
each request slot holds, the free list, and the page-bucket policy that
bounds the gather width of the decode step.

Allocation is reservation-based: a request reserves every page its full
lifetime (prompt + max_new positions) needs at admission, so decode can
never OOM mid-flight and the admission decision is a pure function of the
free-list length — deterministic, replayable.  The LAST physical page
(index ``n_pages``) is the dump page: unreserved table entries point at it,
inactive decode slots scatter into it, and no live request ever gathers it
with nonzero attention probability.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.messages import pad_pow2


def pages_needed(n_positions: int, page_size: int) -> int:
    return -(-n_positions // page_size)


def bucket_pages(needed: int, pages_per_req: int) -> int:
    """Gather-width bucket (in pages) for the longest active request:
    next power of two, capped at the per-request maximum, so the decode
    step runs at O(log pages_per_req) distinct widths."""
    if needed <= 0:
        needed = 1
    return min(pad_pow2(needed, minimum=1), pages_per_req)


class PageAllocator:
    """LIFO free-list allocator over the physical page pool.

    ``table`` is the dense (max_batch, pages_per_req) int32 page table the
    decode step consumes directly (sliced to the active bucket width);
    unreserved entries hold the dump page id.
    """

    def __init__(self, n_pages: int, page_size: int, max_batch: int,
                 pages_per_req: int):
        if n_pages < pages_per_req:
            raise ValueError(f"pool of {n_pages} pages cannot hold even one "
                             f"full request ({pages_per_req} pages)")
        self.n_pages = n_pages
        self.page_size = page_size
        self.pages_per_req = pages_per_req
        self.dump = n_pages
        # pop() yields lowest ids first; released pages are re-pushed so the
        # next alloc reuses them in the same order (pinned by the serve tests)
        self._free = list(range(n_pages - 1, -1, -1))
        self.table = np.full((max_batch, pages_per_req), self.dump, np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def can_alloc(self, k: int) -> bool:
        return k <= self.pages_per_req and k <= len(self._free)

    def alloc(self, slot: int, k: int) -> list[int]:
        """Reserve ``k`` pages for request slot ``slot``; returns their ids."""
        if not self.can_alloc(k):
            raise ValueError(f"cannot allocate {k} pages "
                             f"({len(self._free)} free, "
                             f"{self.pages_per_req} per-request max)")
        if (self.table[slot] != self.dump).any():
            raise ValueError(f"slot {slot} already holds pages")
        pages = [self._free.pop() for _ in range(k)]
        self.table[slot, :k] = pages
        return pages

    def release(self, slot: int) -> list[int]:
        """Return slot ``slot``'s pages to the free list (eviction)."""
        pages = [int(p) for p in self.table[slot] if p != self.dump]
        self._free.extend(reversed(pages))
        self.table[slot] = self.dump
        return pages
