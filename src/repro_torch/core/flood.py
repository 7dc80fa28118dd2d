"""Flooding as a consensus primitive (paper §3.3, Algorithm 1 block (C)).

The port's copy of the per-message reference engine of
``repro/core/flood.py`` over a static graph (no churn).  Upon first receipt
a client forwards a message to all neighbours on the next round; duplicates
are filtered against its seen-set.  Running only ``k`` rounds per step and
carrying the frontiers over is delayed flooding (paper §4.5).

Payload order matters: it fixes the order in which a receiver sums the
messages into its weights, so this engine reproduces the reference's
order exactly (sorted neighbour lists, frontier order).
"""
from __future__ import annotations

import dataclasses

import networkx as nx
import numpy as np

from repro_torch.core.messages import CommLedger, Message, MESSAGE_BYTES, \
    pad_pow2
from repro_torch.topology import graphs

#: Sender-step value marking padding columns in dense payload matrices.
STEP_PAD = -1
#: The JAX package switches to its bitset engine at this many clients; its
#: payload order differs, so the port refuses to stand in for it there.
MAX_CLIENTS = 64


def pad_payloads(payloads, minimum: int = 4):
    """Stack per-client ragged ``(seeds, coefs, steps)`` payloads into dense
    ``(n, K)`` matrices, K pow2-bucketed; padding is ``(0, 0.0, STEP_PAD)``,
    an exact no-op under SubCGE."""
    n = len(payloads)
    kmax = max((len(p[0]) for p in payloads), default=0)
    if kmax == 0:
        return (np.zeros((n, 0), np.uint32), np.zeros((n, 0), np.float32),
                np.full((n, 0), STEP_PAD, np.int32))
    K = pad_pow2(kmax, minimum)
    seeds = np.zeros((n, K), np.uint32)
    coefs = np.zeros((n, K), np.float32)
    steps = np.full((n, K), STEP_PAD, np.int32)
    for i, (sd, cf, st) in enumerate(payloads):
        k = len(sd)
        seeds[i, :k] = sd
        coefs[i, :k] = cf
        steps[i, :k] = st
    return seeds, coefs, steps


@dataclasses.dataclass
class ClientFloodState:
    seen: set            # S_i — uids of every message ever accepted
    frontier: list       # R_i — messages to forward on the next round


class FloodNetwork:
    """Per-message flood engine over a static connected graph."""

    def __init__(self, graph: nx.Graph):
        if not nx.is_connected(graph):
            raise ValueError("SeedFlood assumes a connected communication graph")
        self.n = graph.number_of_nodes()
        if self.n >= MAX_CLIENTS:
            raise NotImplementedError(
                f"{self.n} clients: the bitset flood engine is not ported")
        self.neighbors = graphs.neighbors(graph)
        self.diameter = max(graphs.diameter(graph), 1)
        self.ledger = CommLedger(n_edges=graph.number_of_edges())
        self.states = [ClientFloodState(set(), []) for _ in range(self.n)]

    def active_mask(self) -> np.ndarray:
        return np.ones(self.n, dtype=bool)

    def inject(self, client: int, msg: Message) -> None:
        """A client's fresh (already locally applied) update enters its own
        frontier."""
        st = self.states[client]
        if msg.uid in st.seen:
            raise ValueError(f"duplicate injection of {msg.uid}")
        st.seen.add(msg.uid)
        st.frontier.append(msg)

    def round(self) -> list[list[Message]]:
        """One synchronous round; returns each client's newly accepted
        messages (deduplicated), charging every transmission."""
        inboxes: list[list[Message]] = [[] for _ in range(self.n)]
        for i in range(self.n):
            st = self.states[i]
            if not st.frontier:
                continue
            payload = len(st.frontier) * MESSAGE_BYTES
            for j in self.neighbors[i]:
                inboxes[j].extend(st.frontier)
                self.ledger.send(payload, count=len(st.frontier))
            st.frontier = []
        fresh: list[list[Message]] = [[] for _ in range(self.n)]
        for i in range(self.n):
            st = self.states[i]
            for msg in inboxes[i]:
                if msg.uid in st.seen:
                    continue
                st.seen.add(msg.uid)
                st.frontier.append(msg)
                fresh[i].append(msg)
        return fresh

    def rounds(self, k: int) -> list[list[Message]]:
        """k rounds (fewer once quiescent); per-client accepted messages."""
        fresh: list[list[Message]] = [[] for _ in range(self.n)]
        for _ in range(k):
            if self.in_flight() == 0:
                break
            for i, got in enumerate(self.round()):
                fresh[i].extend(got)
        return fresh

    def rounds_padded(self, k: int, minimum: int = 4):
        """k rounds -> padded ``(n, K)`` seed / coef / sender-step matrices."""
        return pad_payloads(
            [(np.asarray([m.seed for m in f], np.uint32),
              np.asarray([m.coef for m in f], np.float32),
              np.asarray([m.step for m in f], np.int32))
             for f in self.rounds(k)], minimum)

    def in_flight(self) -> int:
        return sum(len(st.frontier) for st in self.states)

