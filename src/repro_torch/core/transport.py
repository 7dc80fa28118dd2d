"""Transport plugins: the communication half of the Method × Transport API
(the port of ``repro/core/transport.py`` on a static graph).

A transport owns the network substrate (flood engine, mixing matrix, or
nothing) and the :class:`~repro_torch.core.messages.CommLedger`.  Byte
accounting lives here and nowhere else: a method never sees the ledger, so
the paper's cost metric cannot drift between methods.

* :class:`FloodTransport`    — seed–scalar flooding (``core.flood``) with a
  ``k``-hop budget per step and an end-of-run drain.
* :class:`GossipTransport`   — mixing-matrix parameter exchange every
  ``every`` steps, optionally through Choco compressed differences.
* :class:`GossipSRTransport` — the §3.2 strawman: full seed–scalar
  histories across every edge, averaged under the mixing matrix.
* :class:`NullTransport`     — no communication (the centralized oracle).

The graph and the mixing matrix are fixed for the run: the port has no
churn (no ``DynamicTopology``, no ``apply_churn``) and no checkpoints, so
every client is always online and ``exchange``'s ``active`` mask (the
JAX package's signature; None = all online) changes nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np

from repro_torch.core import flood, gossip, messages
from repro_torch.core.messages import MESSAGE_BYTES, CommLedger
from repro_torch.topology import graphs


@dataclasses.dataclass
class FloodInbox:
    """One step's newly delivered payloads as dense padded ``(n, K)``
    seed / coef / sender-step matrices, and the receiver step ``t``."""
    seeds: np.ndarray
    coefs: np.ndarray
    steps: np.ndarray
    t: int


class TransportBase:
    """Default hooks so concrete transports only override what they use."""

    ledger: CommLedger
    n: int

    def bind(self, init_payload: Any) -> None:
        pass

    def active_mask(self) -> np.ndarray:
        return np.ones(self.n, dtype=bool)

    def stats(self) -> dict:
        return {}


class FloodTransport(TransportBase):
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

    def exchange(self, payload, t: int,
                 active: np.ndarray | None = None) -> FloodInbox:
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


class GossipTransport(TransportBase):
    """Mixing-matrix parameter exchange, optionally Choco-compressed.

    ``exchange`` fires every ``every`` steps (``local_iters``) and returns
    the mixed trainable dict; other steps return None.  With
    ``choco_density`` set, differences are top-k compressed through
    per-client surrogate copies whose state lives here (it is communication
    state, not method state)."""

    def __init__(self, graph, W: np.ndarray, *, every: int,
                 choco_density: float | None = None):
        self.n = graph.number_of_nodes()
        self.W = W
        self.every = every
        self.density = choco_density
        self.ledger = CommLedger(n_edges=graph.number_of_edges())
        self._choco = None

    def bind(self, init_payload) -> None:
        if self.density is not None:
            # paper App. B.2: surrogates start at the pretrained weights
            self._choco = gossip.choco_init(init_payload)

    def exchange(self, trainable: dict, t: int,
                 active: np.ndarray | None = None):
        if (t + 1) % self.every != 0:
            return None
        floats_per_client = sum(v.numel() for v in trainable.values()) // self.n
        edges = self.ledger.n_edges
        if self.density is not None:
            trainable, self._choco = gossip.choco_round(
                trainable, self._choco, self.W, self.density)
            self.ledger.send(2 * edges * messages.topk_payload_bytes(
                floats_per_client, self.density))
        else:
            trainable = gossip.mix(trainable, self.W)
            self.ledger.send(2 * edges * messages.dense_payload_bytes(
                floats_per_client))
        return trainable


class GossipSRTransport(TransportBase):
    """Gossip with shared randomness (§3.2 strawman): every ``every`` steps
    each client ships its FULL coefficient history to every neighbour —
    O(t·n) bytes per edge — and histories are averaged under the mixing
    matrix (eq. 8)."""

    def __init__(self, graph, W: np.ndarray, *, every: int):
        self.W = W
        self.every = every
        self.neigh = graphs.neighbors(graph)
        self.n = graph.number_of_nodes()
        self.ledger = CommLedger(n_edges=graph.number_of_edges())

    def exchange(self, hist: list[dict], t: int,
                 active: np.ndarray | None = None):
        if (t + 1) % self.every != 0:
            return None
        n, W = self.n, self.W
        all_uids = set()
        for i in range(n):
            all_uids |= set(hist[i].keys())
        for i in range(n):
            for j in self.neigh[i]:
                self.ledger.send(len(hist[j]) * MESSAGE_BYTES,
                                 count=len(hist[j]))
        new_hist = []
        for i in range(n):
            h = {}
            # uid order decides the delta replay's float order downstream.
            # uids are (client, step) int tuples: CPython hashes them
            # unsalted, so the set iterates in the same order on every run
            # given the same insertion history, which is the JAX package's;
            # sorted() would diverge from it bit for bit.
            for uid in all_uids:  # sfcheck: noqa[SF003] -- int-tuple uids hash unsalted; order is deterministic and the JAX package's (tests/test_torch_methods_zo.py)
                cbar = sum(W[i, j] * hist[j].get(uid, [0, 0, 0.0])[2]
                           for j in range(n) if W[i, j] > 0)
                ref = next(hist[j][uid] for j in range(n) if uid in hist[j])
                h[uid] = [ref[0], ref[1], cbar]
            new_hist.append(h)
        return new_hist


class NullTransport(TransportBase):
    """No communication (the centralized equivalence oracle)."""

    def __init__(self, n: int):
        self.n = n
        self.ledger = CommLedger()

    def exchange(self, payload, t: int,
                 active: np.ndarray | None = None):
        return None
