"""Flooding as a consensus primitive (paper §3.3, Algorithm 1 block (C)).

The port's copy of the two engines of ``repro/core/flood.py`` over a static
graph (no churn).  Upon first receipt a client forwards a message to all
neighbours on the next round; duplicates are filtered against its seen-set.
Running only ``k`` rounds per step and carrying the frontiers over is
delayed flooding (paper §4.5).

* ``FloodNetwork``       — the per-message reference engine.
* ``VectorFloodNetwork`` — the bitset engine: seen and frontier sets are
  packed bit rows over an append-only message table, a round is one
  OR-gather over the flat adjacency and an AND-NOT.

The two deliver the same message sets and charge the same ledger, but in
different payload orders, and payload order fixes the order in which a
receiver sums the messages into its weights.  So each engine reproduces
its JAX counterpart's order exactly, and ``make_network(backend="auto")``
switches engines at the reference's client count.
"""
from __future__ import annotations

import dataclasses

import networkx as nx
import numpy as np

from repro_torch.core.messages import CommLedger, Message, MESSAGE_BYTES, \
    pad_pow2
from repro_torch.topology import graphs

#: ``make_network(backend="auto")`` switches to the bitset engine at this size.
AUTO_VECTOR_MIN_CLIENTS = 64

#: Sender-step value marking padding columns in dense payload matrices.
STEP_PAD = -1

#: Set bits of every byte value.  Counts the same integers as
#: ``np.bitwise_count``, which needs numpy >= 2.0.
_POPCOUNT = np.array([bin(b).count("1") for b in range(256)], np.int64)


def popcount_rows(bits: np.ndarray) -> np.ndarray:
    """Set bits of each row of a packed (n, nbytes) uint8 matrix: (n,)."""
    return _POPCOUNT[bits].sum(axis=1)


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


class _FloodBase:
    """The static graph, the ledger and the padded payloads of both engines."""

    def __init__(self, graph: nx.Graph):
        if not nx.is_connected(graph):
            raise ValueError("SeedFlood assumes a connected communication graph")
        self.n = graph.number_of_nodes()
        self.neighbors = graphs.neighbors(graph)
        self.diameter = max(graphs.diameter(graph), 1)
        self.ledger = CommLedger(n_edges=graph.number_of_edges())

    def active_mask(self) -> np.ndarray:
        return np.ones(self.n, dtype=bool)

    def rounds_padded(self, k: int, minimum: int = 4):
        """k rounds -> padded ``(n, K)`` seed / coef / sender-step matrices."""
        return pad_payloads(self.rounds_arrays(k), minimum)

    def full_flood(self) -> list[list[Message]]:
        """Flood until quiescent (diameter + 1 rounds suffice)."""
        return self.rounds(self.diameter + 1)


@dataclasses.dataclass
class ClientFloodState:
    seen: set            # S_i — uids of every message ever accepted
    frontier: list       # R_i — messages to forward on the next round


class FloodNetwork(_FloodBase):
    """Per-message flood engine over a static connected graph."""

    def __init__(self, graph: nx.Graph):
        super().__init__(graph)
        self.states = [ClientFloodState(set(), []) for _ in range(self.n)]

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

    def rounds_arrays(self, k: int):
        """k rounds -> per-client ``(seeds, coefs, steps)`` arrays, in the
        order the messages were accepted."""
        return [(np.asarray([m.seed for m in f], np.uint32),
                 np.asarray([m.coef for m in f], np.float32),
                 np.asarray([m.step for m in f], np.int32))
                for f in self.rounds(k)]

    def in_flight(self) -> int:
        return sum(len(st.frontier) for st in self.states)


class VectorFloodNetwork(_FloodBase):
    """Bitset engine: the same protocol over packed bit rows.

    Messages live in an append-only table (parallel seed / coef / step
    arrays, capacity doubled when full); each client's seen and frontier
    sets are rows of packed uint8 bit matrices (bit ``j`` of a row is
    message ``j``).  One round: per receiver, OR its neighbours' frontier
    rows, then ``fresh = inbox & ~seen``, ``seen |= fresh``,
    ``frontier = fresh``.  Ledger charges are popcounts, so byte accounting
    matches the per-message engine exactly.  A client's payload lists its
    new messages in ascending table order: the order they were registered.
    """

    _INITIAL_BITS = 512

    def __init__(self, graph: nx.Graph):
        super().__init__(graph)
        self._msgs: list[Message] = []
        self._uid2idx: dict = {}
        self._seeds = np.zeros(self._INITIAL_BITS, np.uint32)
        self._coefs = np.zeros(self._INITIAL_BITS, np.float32)
        self._steps = np.full(self._INITIAL_BITS, STEP_PAD, np.int32)
        nbytes = self._INITIAL_BITS // 8
        self._seen = np.zeros((self.n, nbytes), np.uint8)
        self._front = np.zeros((self.n, nbytes), np.uint8)
        # the reduceat layout of one OR-gather per round: degrees, flat
        # neighbour ids and each node's segment start
        self._deg = np.array([len(ns) for ns in self.neighbors], np.int64)
        self._src = np.asarray([j for ns in self.neighbors for j in ns],
                               np.int64)
        self._seg = np.zeros(self.n, np.int64)
        np.cumsum(self._deg[:-1], out=self._seg[1:])

    def _register(self, msg: Message) -> int:
        idx = len(self._msgs)
        if idx >= self._seeds.shape[0]:
            grow = self._seeds.shape[0]
            self._seeds = np.concatenate([self._seeds,
                                          np.zeros(grow, np.uint32)])
            self._coefs = np.concatenate([self._coefs,
                                          np.zeros(grow, np.float32)])
            self._steps = np.concatenate(
                [self._steps, np.full(grow, STEP_PAD, np.int32)])
            pad = np.zeros((self.n, grow // 8), np.uint8)
            self._seen = np.concatenate([self._seen, pad], axis=1)
            self._front = np.concatenate([self._front, pad], axis=1)
        self._msgs.append(msg)
        self._uid2idx[msg.uid] = idx
        self._seeds[idx] = msg.seed
        self._coefs[idx] = msg.coef
        self._steps[idx] = msg.step
        return idx

    def _rows_indices(self, bits: np.ndarray) -> list[np.ndarray]:
        """Per-row set indices of an (n, nbytes) bit matrix, with one
        unpackbits over the bytes the registered messages occupy."""
        occ = (len(self._msgs) + 7) >> 3
        if occ == 0:
            return [np.zeros(0, np.int64)] * bits.shape[0]
        unpacked = np.unpackbits(bits[:, :occ], axis=1,
                                 bitorder="little")[:, :len(self._msgs)]
        return [np.flatnonzero(row) for row in unpacked]

    def inject(self, client: int, msg: Message) -> None:
        idx = self._uid2idx.get(msg.uid)
        if idx is not None and self._seen[client, idx >> 3] & (1 << (idx & 7)):
            raise ValueError(f"duplicate injection of {msg.uid}")
        if idx is None:
            idx = self._register(msg)
        bit = np.uint8(1 << (idx & 7))
        self._seen[client, idx >> 3] |= bit
        self._front[client, idx >> 3] |= bit

    def _round_bits(self) -> np.ndarray:
        """One synchronous round on the bit matrices; returns fresh bits."""
        sent = int((popcount_rows(self._front) * self._deg).sum())
        if sent:
            self.ledger.send(sent * MESSAGE_BYTES, count=sent)
        if self._src.size:
            # inbox[i] = OR of its neighbours' frontiers: reduceat over the
            # flattened neighbour rows does every segment in one call;
            # zero-degree segments alias a neighbouring row, masked below
            inbox = np.bitwise_or.reduceat(
                self._front[self._src],
                np.minimum(self._seg, self._src.size - 1), axis=0)
            inbox[self._deg == 0] = 0
        else:
            inbox = np.zeros_like(self._front)
        fresh = inbox & ~self._seen
        self._seen |= fresh
        self._front = fresh
        return fresh

    def _rounds_bits(self, k: int) -> np.ndarray:
        acc = np.zeros_like(self._front)
        for _ in range(k):
            if not self._front.any():
                break  # quiescent
            acc |= self._round_bits()
        return acc

    def rounds(self, k: int) -> list[list[Message]]:
        """k rounds (fewer once quiescent); per-client accepted messages."""
        return [[self._msgs[j] for j in idx]
                for idx in self._rows_indices(self._rounds_bits(k))]

    def rounds_arrays(self, k: int):
        """k rounds -> per-client ``(seeds, coefs, steps)`` arrays, in
        ascending registration order, with no ``Message`` objects."""
        acc = self._rounds_bits(k)
        return [(self._seeds[idx], self._coefs[idx], self._steps[idx])
                for idx in self._rows_indices(acc)]

    def in_flight(self) -> int:
        return int(popcount_rows(self._front).sum())


FLOOD_BACKENDS = {"python": FloodNetwork, "numpy": VectorFloodNetwork}


def make_network(graph: nx.Graph, backend: str = "python"):
    """One of the two engines; ``backend="auto"`` picks the bitset engine
    from ``AUTO_VECTOR_MIN_CLIENTS`` clients on, as the reference does."""
    if backend == "auto":
        backend = ("numpy" if graph.number_of_nodes() >= AUTO_VECTOR_MIN_CLIENTS
                   else "python")
    if backend not in FLOOD_BACKENDS:
        raise KeyError(f"unknown flood backend '{backend}' "
                       f"(have {sorted(FLOOD_BACKENDS)} or 'auto')")
    return FLOOD_BACKENDS[backend](graph)
