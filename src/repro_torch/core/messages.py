"""Seed-scalar messages and byte accounting (paper §3.1, Table 1, Fig. 1).

The counterpart of ``repro/core/messages.py`` (host code; the port keeps
its own copy).  A wire message is ``(seed, coef, step)``: a 4-byte uint32
seed, a 2-byte fp16 coefficient and a 2-byte header whose dedup id is the
sender step.  The sender step travels because a receiver must replay every
message under the SubCGE subspace of the sender's τ-epoch.  After churn, a
rejoining client and its sync partner exchange seen-set digests (anti-
entropy) before re-sending only the set difference; the ledger charges
those bytes as ``sync_bytes``.
"""
from __future__ import annotations

import dataclasses

SEED_BYTES = 4      # uint32 seed
COEF_BYTES = 2      # fp16 scalar
HEADER_BYTES = 2    # dedup id == sender step mod 2^16 (uid + epoch replay)
MESSAGE_BYTES = SEED_BYTES + COEF_BYTES + HEADER_BYTES

# Anti-entropy: one seen-set digest is a fixed frame plus 1 byte of
# truncated uid hash per entry.
DIGEST_HEADER_BYTES = 8
DIGEST_BYTES_PER_MSG = 1


def digest_bytes(n_seen: int) -> int:
    """Wire size of one seen-set digest covering ``n_seen`` message uids."""
    return DIGEST_HEADER_BYTES + n_seen * DIGEST_BYTES_PER_MSG


def pad_pow2(k: int, minimum: int = 4) -> int:
    """Smallest power-of-two bucket >= k (padded payload widths)."""
    n = max(1, minimum)
    while n < k:
        n *= 2
    return n


@dataclasses.dataclass(frozen=True)
class Message:
    """One seed-reconstructible ZO update m = (s, α·η/n)."""
    seed: int          # s_{i,t}
    coef: float        # the fixed coefficient (flooding never reweights it)
    origin: int        # producing client
    step: int          # producing iteration: fixes the sender's τ-epoch

    @property
    def uid(self) -> tuple[int, int]:
        return (self.origin, self.step)

    @property
    def nbytes(self) -> int:
        return MESSAGE_BYTES


@dataclasses.dataclass
class CommLedger:
    """Byte counters of one run; ``per_edge`` is the paper's cost metric."""
    total_bytes: int = 0
    n_edges: int = 1
    n_messages: int = 0
    rounds: int = 0
    sync_bytes: int = 0       # anti-entropy digests + re-sent messages
    n_syncs: int = 0          # pairwise digest exchanges

    def send(self, nbytes: int, count: int = 1) -> None:
        self.total_bytes += nbytes
        self.n_messages += count

    def sync(self, nbytes: int, count: int = 0) -> None:
        """Charge one anti-entropy exchange (counts toward total_bytes)."""
        self.total_bytes += nbytes
        self.sync_bytes += nbytes
        self.n_messages += count
        self.n_syncs += 1

    @property
    def per_edge(self) -> float:
        return self.total_bytes / max(1, self.n_edges)


def dense_payload_bytes(n_params: int, dtype_bytes: int = 4) -> int:
    """Bytes to gossip one full model copy (traditional gossip, O(d))."""
    return n_params * dtype_bytes


def topk_payload_bytes(n_params: int, density: float, dtype_bytes: int = 4,
                       index_bytes: int = 4) -> int:
    """ChocoSGD-style top-k sparsified payload: values + indices."""
    k = max(1, int(n_params * density))
    return k * (dtype_bytes + index_bytes)


def fmt_bytes(b: float) -> str:
    """A byte count with a binary unit and two decimals ("2.88KB")."""
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(b) < 1024.0:
            return f"{b:.2f}{unit}"
        b /= 1024.0
    return f"{b:.2f}EB"
