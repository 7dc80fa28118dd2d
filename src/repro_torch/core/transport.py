"""The flood transport: the communication half of the Method × Transport API
(the SeedFlood part of ``repro/core/transport.py``).

Byte accounting lives here and nowhere else: a method never sees the
ledger, so the paper's cost metric cannot drift between methods.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.core import flood
from repro_torch.core.messages import CommLedger


@dataclasses.dataclass
class FloodInbox:
    """One step's newly delivered payloads as dense padded ``(n, K)``
    seed / coef / sender-step matrices, and the receiver step ``t``."""
    seeds: np.ndarray
    coefs: np.ndarray
    steps: np.ndarray
    t: int


class FloodTransport:
    """Seed–scalar flooding with a ``flood_k`` hop budget per step (None =
    full flooding, ``diameter`` rounds) and an end-of-run drain, over the
    engine ``flood.make_network`` picks for ``backend``."""

    def __init__(self, graph, *, backend: str = "auto",
                 flood_k: int | None = None):
        self.net = flood.make_network(graph, backend=backend)
        self.flood_k = flood_k

    @property
    def ledger(self) -> CommLedger:
        return self.net.ledger

    def active_mask(self) -> np.ndarray:
        return self.net.active_mask()

    def exchange(self, payload, t: int) -> FloodInbox:
        for i, msg in payload:
            self.net.inject(i, msg)
        k_hops = self.flood_k if self.flood_k is not None else self.net.diameter
        sds, cfs, stp = self.net.rounds_padded(k_hops)
        return FloodInbox(sds, cfs, stp, t)

    def drain(self, max_iters: int, final_step: int) -> Iterator[FloodInbox]:
        """Flood with no new injections until quiescent, so every sent
        message is delivered."""
        for _ in range(max_iters):
            if self.net.in_flight() == 0:
                break
            sds, cfs, stp = self.net.rounds_padded(self.net.diameter + 1)
            yield FloodInbox(sds, cfs, stp, final_step)

    def stats(self) -> dict:
        return {"n_messages": self.ledger.n_messages,
                "diameter": self.net.diameter,
                "engine": type(self.net).__name__}
