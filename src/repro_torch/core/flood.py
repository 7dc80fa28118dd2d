"""Flooding as a consensus primitive (paper §3.3, Algorithm 1 block (C)).

The port's copy of the two engines of ``repro/core/flood.py``.  Upon first
receipt a client forwards a message to all neighbours on the next round;
duplicates are filtered against its seen-set.  Running only ``k`` rounds
per step and carrying the frontiers over is delayed flooding (paper §4.5).

The network is churn-tolerant: the topology is a
:class:`~repro_torch.topology.dynamic.DynamicTopology`.  Nodes leave
(dropping their frontiers) and rejoin, links fail and recover, partitions
open and heal.  Recovery is an *anti-entropy* sync: across every edge a
rejoin or link-restore revives, the two endpoints exchange seen-set
digests and re-send exactly the messages the other side missed.  Re-sent
messages enter the receiver's frontier and re-flood outward; duplicates are
filtered by the seen-sets, so coefficients still arrive exactly once and
unchanged.  What a client gains this way is its *catch-up*, which the
transport prepends to the next step's payload (``rounds_padded(extra=)``).

* ``FloodNetwork``       — the per-message reference engine.
* ``VectorFloodNetwork`` — the bitset engine: seen and frontier sets are
  packed bit rows over an append-only message table, a round is one
  OR-gather over the flat adjacency and an AND-NOT.

The two deliver the same message sets and charge the same ledger, but in
different payload orders, and payload order fixes the order in which a
receiver sums the messages into its weights.  So each engine reproduces
its JAX counterpart's order exactly, catch-up and ``load_state_dict``
included, and ``make_network(backend="auto")`` switches engines at the
reference's client count.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

from repro_torch.core.messages import CommLedger, Message, MESSAGE_BYTES, \
    digest_bytes, pad_pow2
from repro_torch.topology.dynamic import ChurnEvent, DynamicTopology

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


def _as_arrays(msgs) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    return (np.asarray([m.seed for m in msgs], np.uint32),
            np.asarray([m.coef for m in msgs], np.float32),
            np.asarray([m.step for m in msgs], np.int32))


@dataclasses.dataclass
class ClientFloodState:
    seen: set            # S_i — uids of every message ever accepted
    frontier: list       # R_i — messages to forward on the next round
    store: dict          # uid -> Message, for anti-entropy re-send

    @classmethod
    def empty(cls) -> "ClientFloodState":
        return cls(seen=set(), frontier=[], store={})


@dataclasses.dataclass
class SyncReport:
    """Anti-entropy accounting for one ``apply_churn`` call."""
    syncs: int = 0            # pairwise digest exchanges performed
    transferred: int = 0      # messages re-sent to close the set difference


def _as_topology(graph) -> DynamicTopology:
    if isinstance(graph, DynamicTopology):
        return graph
    return DynamicTopology(graph)


class _FloodBase:
    """Topology, churn entry point, ledger and padded payloads of both
    engines."""

    def __init__(self, graph):
        self.topo = _as_topology(graph)
        self.graph = self.topo.base_graph
        self.n = self.topo.n
        self.ledger = CommLedger(n_edges=self.graph.number_of_edges())
        self._catchup: list[list[Message]] = [[] for _ in range(self.n)]

    @property
    def neighbors(self) -> list[list[int]]:
        return self.topo.neighbors()

    @property
    def diameter(self) -> int:
        """Effective diameter of the *current* topology (max over live
        components): the flood-rounds budget for full coverage."""
        return max(self.topo.effective_diameter(), 1)

    def active_mask(self) -> np.ndarray:
        return self.topo.active_mask()

    def _check_online(self, client: int) -> None:
        if not self.topo.is_active(client):
            raise ValueError(f"client {client} is offline")

    # -- churn ----------------------------------------------------------------

    def apply_churn(self, events: Iterable[ChurnEvent]) -> SyncReport:
        """Apply topology mutations; departed nodes drop their frontiers,
        rejoined nodes and restored links run anti-entropy.  A rejoin syncs
        across *every* revived live edge: each may face a different
        component whose messages the others never saw."""
        delta = self.topo.apply_events(events)
        report = SyncReport()
        for i in delta.left:
            self._drop_frontier(i)
        synced: set[frozenset] = set()
        neighbors = self.topo.neighbors()
        for i, _ in delta.joined:
            for j in neighbors[i]:
                if frozenset((i, j)) not in synced:
                    synced.add(frozenset((i, j)))
                    self._anti_entropy(i, j, report)
        for u, v in delta.restored:
            if self.topo.is_active(u) and self.topo.is_active(v) \
                    and frozenset((u, v)) not in synced:
                synced.add(frozenset((u, v)))
                self._anti_entropy(u, v, report)
        return report

    def drain_catchup(self) -> list[list[Message]]:
        """Messages each client gained through anti-entropy since the last
        drain (applied like freshly flooded messages)."""
        out = self._catchup
        self._catchup = [[] for _ in range(self.n)]
        return out

    def drain_catchup_arrays(self):
        """:meth:`drain_catchup` as per-client ``(seeds, coefs, steps)``
        arrays, sender steps included so that catch-up replays under the
        right τ-epoch."""
        return [_as_arrays(f) for f in self.drain_catchup()]

    def rounds_padded(self, k: int, extra=None, minimum: int = 4):
        """k rounds -> padded ``(n, K)`` seed / coef / sender-step matrices.
        ``extra`` (per-client ``(seeds, coefs, steps)``, the anti-entropy
        catch-up) is prepended to each client's payload."""
        payloads = self.rounds_arrays(k)
        if extra is not None:
            payloads = [tuple(np.concatenate([np.asarray(e, p.dtype), p])
                              for e, p in zip(ex, pl))
                        for ex, pl in zip(extra, payloads)]
        return pad_payloads(payloads, minimum)

    def full_flood(self) -> list[list[Message]]:
        """Flood until quiescent (diameter + 1 rounds suffice)."""
        return self.rounds(self.diameter + 1)

    # engine hooks
    def _drop_frontier(self, i: int) -> None:
        raise NotImplementedError

    def _anti_entropy(self, a: int, b: int, report: SyncReport) -> None:
        raise NotImplementedError

    # -- checkpointing ---------------------------------------------------------
    # ``state_dict`` returns (arrays, meta): arrays for the .npz side of a
    # checkpoint, a JSON-serializable dict for its metadata; the layout is
    # the JAX package's.  Frontier and catch-up index arrays are ORDERED:
    # forwarding order fixes payload order, which fixes summation order.

    @staticmethod
    def _messages_arrays(msgs: list[Message]) -> dict:
        return {
            "seed": np.asarray([m.seed for m in msgs], np.int64),
            "coef": np.asarray([m.coef for m in msgs], np.float64),
            "origin": np.asarray([m.origin for m in msgs], np.int64),
            "step": np.asarray([m.step for m in msgs], np.int64),
        }

    @staticmethod
    def _messages_from_arrays(m: dict) -> list[Message]:
        return [Message(seed=int(s), coef=float(c), origin=int(o), step=int(t))
                for s, c, o, t in zip(np.asarray(m["seed"]),
                                      np.asarray(m["coef"]),
                                      np.asarray(m["origin"]),
                                      np.asarray(m["step"]))]

    def _load_catchup(self, arrays: dict, msgs: list[Message]) -> None:
        self._catchup = [
            [msgs[int(k)] for k in np.asarray(arrays[f"catchup{i}"], np.int64)]
            for i in range(self.n)]


class FloodNetwork(_FloodBase):
    """Per-message flood engine."""

    def __init__(self, graph):
        super().__init__(graph)
        self.states = [ClientFloodState.empty() for _ in range(self.n)]

    def inject(self, client: int, msg: Message) -> None:
        """A client's fresh (already locally applied) update enters its own
        frontier."""
        self._check_online(client)
        st = self.states[client]
        if msg.uid in st.seen:
            raise ValueError(f"duplicate injection of {msg.uid}")
        st.seen.add(msg.uid)
        st.store[msg.uid] = msg
        st.frontier.append(msg)

    def round(self) -> list[list[Message]]:
        """One synchronous round; returns each client's newly accepted
        messages (deduplicated), charging every transmission."""
        neighbors = self.neighbors
        inboxes: list[list[Message]] = [[] for _ in range(self.n)]
        for i in range(self.n):
            st = self.states[i]
            if not st.frontier:
                continue
            payload = len(st.frontier) * MESSAGE_BYTES
            for j in neighbors[i]:
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
                st.store[msg.uid] = msg
                st.frontier.append(msg)
                fresh[i].append(msg)
        self.ledger.rounds += 1
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
        return [_as_arrays(f) for f in self.rounds(k)]

    # -- churn hooks -----------------------------------------------------------
    def _drop_frontier(self, i: int) -> None:
        self.states[i].frontier = []

    def _anti_entropy(self, a: int, b: int, report: SyncReport) -> None:
        """Symmetric digest exchange across one live edge: each side re-sends
        the messages the other is missing, in uid order.  They join the
        receiver's frontier and its catch-up."""
        sa, sb = self.states[a], self.states[b]
        payload = digest_bytes(len(sa.seen)) + digest_bytes(len(sb.seen))
        moved = 0
        for dst, dst_state, src_state in ((a, sa, sb), (b, sb, sa)):
            missed = sorted(src_state.seen - dst_state.seen)
            for uid in missed:
                msg = src_state.store[uid]
                dst_state.seen.add(uid)
                dst_state.store[uid] = msg
                dst_state.frontier.append(msg)
                self._catchup[dst].append(msg)
            moved += len(missed)
        self.ledger.sync(payload + moved * MESSAGE_BYTES, count=moved)
        report.syncs += 1
        report.transferred += moved

    # -- checkpointing ---------------------------------------------------------
    def state_dict(self) -> tuple[dict, dict]:
        union: dict = {}
        for st in self.states:
            union.update(st.store)
        uids = sorted(union)
        idx = {uid: k for k, uid in enumerate(uids)}
        arrays: dict = {"msgs": self._messages_arrays([union[u] for u in uids])}
        for i, st in enumerate(self.states):
            arrays[f"seen{i}"] = np.asarray(
                sorted(idx[u] for u in st.seen), np.int64)
            arrays[f"frontier{i}"] = np.asarray(
                [idx[m.uid] for m in st.frontier], np.int64)
            arrays[f"catchup{i}"] = np.asarray(
                [idx[m.uid] for m in self._catchup[i]], np.int64)
        return arrays, {"engine": "python", "topo": self.topo.state_dict()}

    def load_state_dict(self, arrays: dict, meta: dict) -> None:
        self.topo.load_state_dict(meta["topo"])
        msgs = self._messages_from_arrays(arrays["msgs"])
        self.states = [ClientFloodState.empty() for _ in range(self.n)]
        for i, st in enumerate(self.states):
            for k in np.asarray(arrays[f"seen{i}"], np.int64):
                m = msgs[int(k)]
                st.seen.add(m.uid)
                st.store[m.uid] = m
            st.frontier = [msgs[int(k)] for k in
                           np.asarray(arrays[f"frontier{i}"], np.int64)]
        self._load_catchup(arrays, msgs)

    # -- introspection ---------------------------------------------------------
    def in_flight(self) -> int:
        return sum(len(st.frontier) for st in self.states)

    def coverage(self, uid) -> int:
        """How many clients have accepted message ``uid``."""
        return sum(uid in st.seen for st in self.states)

    def seen_uids(self, i: int) -> set:
        return set(self.states[i].seen)


class VectorFloodNetwork(_FloodBase):
    """Bitset engine: the same protocol over packed bit rows.

    Messages live in an append-only table (parallel seed / coef / step
    arrays, capacity doubled when full); each client's seen and frontier
    sets are rows of packed uint8 bit matrices (bit ``j`` of a row is
    message ``j``).  One round: per receiver, OR its live neighbours'
    frontier rows, then ``fresh = inbox & ~seen``, ``seen |= fresh``,
    ``frontier = fresh``.  Ledger charges are popcounts, so byte accounting
    matches the per-message engine exactly.  A client's payload, and its
    catch-up, list messages in ascending table order: the order they were
    registered.
    """

    _INITIAL_BITS = 512

    def __init__(self, graph):
        super().__init__(graph)
        self._reset_tables()
        self._adj_version = -1
        self._adj: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None

    def _reset_tables(self) -> None:
        self._msgs: list[Message] = []
        self._uid2idx: dict = {}
        self._seeds = np.zeros(self._INITIAL_BITS, np.uint32)
        self._coefs = np.zeros(self._INITIAL_BITS, np.float32)
        self._steps = np.full(self._INITIAL_BITS, STEP_PAD, np.int32)
        nbytes = self._INITIAL_BITS // 8
        self._seen = np.zeros((self.n, nbytes), np.uint8)
        self._front = np.zeros((self.n, nbytes), np.uint8)

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

    @staticmethod
    def _get_bit(mat: np.ndarray, row: int, idx: int) -> bool:
        return bool(mat[row, idx >> 3] & (1 << (idx & 7)))

    def _occ_bytes(self) -> int:
        """Bytes of the bit rows the registered messages occupy."""
        return (len(self._msgs) + 7) >> 3

    def _rows_indices(self, bits: np.ndarray) -> list[np.ndarray]:
        """Per-row set indices of an (n, nbytes) bit matrix, with one
        unpackbits over the bytes the registered messages occupy."""
        occ = self._occ_bytes()
        if occ == 0:
            return [np.zeros(0, np.int64)] * bits.shape[0]
        unpacked = np.unpackbits(bits[:, :occ], axis=1,
                                 bitorder="little")[:, :len(self._msgs)]
        return [np.flatnonzero(row) for row in unpacked]

    def inject(self, client: int, msg: Message) -> None:
        self._check_online(client)
        idx = self._uid2idx.get(msg.uid)
        if idx is not None and self._get_bit(self._seen, client, idx):
            raise ValueError(f"duplicate injection of {msg.uid}")
        if idx is None:
            idx = self._register(msg)
        bit = np.uint8(1 << (idx & 7))
        self._seen[client, idx >> 3] |= bit
        self._front[client, idx >> 3] |= bit

    def _flat_adjacency(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(degrees, flat neighbour ids, per-node segment starts): the
        reduceat layout of one OR-gather per round, rebuilt when the
        topology changes."""
        if self._adj_version != self.topo.version:
            nbrs = self.neighbors
            deg = np.array([len(ns) for ns in nbrs], np.int64)
            src = np.asarray([j for ns in nbrs for j in ns], np.int64)
            seg = np.zeros(self.n, np.int64)
            np.cumsum(deg[:-1], out=seg[1:])
            self._adj = (deg, src, seg)
            self._adj_version = self.topo.version
        return self._adj

    def _round_bits(self) -> np.ndarray:
        """One synchronous round on the bit matrices; returns fresh bits."""
        deg, src, seg = self._flat_adjacency()
        sent = int((popcount_rows(self._front) * deg).sum())
        if sent:
            self.ledger.send(sent * MESSAGE_BYTES, count=sent)
        if src.size:
            # inbox[i] = OR of its neighbours' frontiers: reduceat over the
            # flattened neighbour rows does every segment in one call;
            # zero-degree segments alias a neighbouring row, masked below
            inbox = np.bitwise_or.reduceat(
                self._front[src], np.minimum(seg, src.size - 1), axis=0)
            inbox[deg == 0] = 0
        else:
            inbox = np.zeros_like(self._front)
        fresh = inbox & ~self._seen
        self._seen |= fresh
        self._front = fresh
        self.ledger.rounds += 1
        return fresh

    def _rounds_bits(self, k: int) -> np.ndarray:
        acc = np.zeros_like(self._front)
        for _ in range(k):
            if not self._front.any():
                break  # quiescent
            acc |= self._round_bits()
        return acc

    def round(self) -> list[list[Message]]:
        """One round: per client, the messages newly accepted in it."""
        return [[self._msgs[j] for j in idx]
                for idx in self._rows_indices(self._round_bits())]

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

    # -- churn hooks -----------------------------------------------------------
    def _drop_frontier(self, i: int) -> None:
        self._front[i] = 0

    def _anti_entropy(self, a: int, b: int, report: SyncReport) -> None:
        seen = popcount_rows(self._seen[[a, b]])
        payload = digest_bytes(int(seen[0])) + digest_bytes(int(seen[1]))
        moved = 0
        for dst, src in ((a, b), (b, a)):
            missed = self._seen[src] & ~self._seen[dst]
            m = int(_POPCOUNT[missed].sum())
            if m:
                self._seen[dst] |= missed
                self._front[dst] |= missed
                self._catchup[dst].extend(
                    self._msgs[j] for j in self._rows_indices(missed[None])[0])
            moved += m
        self.ledger.sync(payload + moved * MESSAGE_BYTES, count=moved)
        report.syncs += 1
        report.transferred += moved

    # -- checkpointing ---------------------------------------------------------
    def state_dict(self) -> tuple[dict, dict]:
        occ = self._occ_bytes()
        arrays: dict = {
            "msgs": self._messages_arrays(self._msgs),
            "seen": self._seen[:, :occ].copy(),
            "front": self._front[:, :occ].copy(),
        }
        for i, f in enumerate(self._catchup):
            arrays[f"catchup{i}"] = np.asarray(
                [self._uid2idx[m.uid] for m in f], np.int64)
        return arrays, {"engine": "numpy", "topo": self.topo.state_dict()}

    def load_state_dict(self, arrays: dict, meta: dict) -> None:
        self.topo.load_state_dict(meta["topo"])
        msgs = self._messages_from_arrays(arrays["msgs"])
        # re-register into fresh tables: the table and uid2idx rebuild
        # deterministically from the message list, and capacity regrows
        # geometrically just as it did live
        self._reset_tables()
        for m in msgs:
            self._register(m)
        occ = self._occ_bytes()
        self._seen[:, :occ] = np.asarray(arrays["seen"], np.uint8)
        self._front[:, :occ] = np.asarray(arrays["front"], np.uint8)
        self._load_catchup(arrays, msgs)
        self._adj_version = -1   # rebuild the adjacency against the topology

    # -- introspection ---------------------------------------------------------
    def in_flight(self) -> int:
        return int(popcount_rows(self._front).sum())

    def coverage(self, uid) -> int:
        idx = self._uid2idx.get(uid)
        if idx is None:
            return 0
        return sum(self._get_bit(self._seen, i, idx) for i in range(self.n))

    def seen_uids(self, i: int) -> set:
        return {self._msgs[j].uid
                for j in self._rows_indices(self._seen[i][None])[0]}


FLOOD_BACKENDS = {"python": FloodNetwork, "numpy": VectorFloodNetwork}


def make_network(graph, backend: str = "python"):
    """One of the two engines; ``backend="auto"`` picks the bitset engine
    from ``AUTO_VECTOR_MIN_CLIENTS`` clients on, as the reference does."""
    if backend == "auto":
        n = (graph.n if isinstance(graph, DynamicTopology)
             else graph.number_of_nodes())
        backend = "numpy" if n >= AUTO_VECTOR_MIN_CLIENTS else "python"
    if backend not in FLOOD_BACKENDS:
        raise KeyError(f"unknown flood backend '{backend}' "
                       f"(have {sorted(FLOOD_BACKENDS)} or 'auto')")
    return FLOOD_BACKENDS[backend](graph)


def staleness_bound(diameter: int, k: int) -> int:
    """Paper §4.5: delayed flooding with k hops per iteration bounds message
    staleness by ⌈D/k⌉ iterations."""
    return -(-diameter // k)


def flood_bytes_per_iteration(graph, n_new_messages: int) -> int:
    """Upper bound on bytes a full flood of ``n_new_messages`` costs: each
    message traverses each *directed* edge at most once."""
    return 2 * graph.number_of_edges() * n_new_messages * MESSAGE_BYTES


def gossip_sr_history_bytes(t: int, n: int, graph) -> int:
    """Gossip with shared randomness (paper §3.2): at iteration t each edge
    carries the O(t·n) full history of seed–scalar pairs."""
    return 2 * graph.number_of_edges() * t * n * MESSAGE_BYTES
