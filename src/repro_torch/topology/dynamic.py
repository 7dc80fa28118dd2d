"""Dynamic topology: timed churn over a base communication graph (the
port's copy of ``repro/topology/dynamic.py``).

* ``ChurnEvent`` / ``ChurnSchedule`` — a step-indexed script of topology
  mutations (node leave/join, link failure/recovery, transient partitions)
  and a seeded random-churn generator that draws from
  ``np.random.default_rng(seed)`` in the reference's order, so the same
  seed gives the same events.
* ``DynamicTopology`` — the mutable view of a base graph: which nodes are
  online, which links are up, current neighbour lists, and the effective
  (per-component) diameter.  Protocols consume ``TopologyDelta``s, e.g. the
  restored edges that trigger the flood layer's anti-entropy sync.

The base graph stays fixed; churn toggles membership of its nodes and
edges, so every mutation is invertible.  The effective diameter comes from
networkx's BFS (the reference prefers scipy's; both give the largest finite
distance between live online nodes).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import networkx as nx
import numpy as np


EVENT_KINDS = ("leave", "join", "link_down", "link_up", "partition", "heal")


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """One timed topology mutation, applied at the *start* of ``step``."""
    step: int
    kind: str                                   # one of EVENT_KINDS
    nodes: tuple[int, ...] = ()                 # leave / join
    edges: tuple[tuple[int, int], ...] = ()     # link_down / link_up
    groups: tuple[tuple[int, ...], ...] = ()    # partition

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown churn event kind '{self.kind}'")
        if self.step < 0:
            raise ValueError("churn events must be scheduled at step >= 0")
        if self.kind in ("leave", "join") and not self.nodes:
            raise ValueError(f"'{self.kind}' event needs nodes")
        if self.kind in ("link_down", "link_up") and not self.edges:
            raise ValueError(f"'{self.kind}' event needs edges")
        if self.kind == "partition" and len(self.groups) < 2:
            raise ValueError("'partition' event needs >= 2 groups")


class ChurnSchedule:
    """An immutable, step-sorted script of :class:`ChurnEvent`."""

    def __init__(self, events: Iterable[ChurnEvent]):
        self.events: tuple[ChurnEvent, ...] = tuple(
            sorted(events, key=lambda e: e.step))
        self._by_step: dict[int, list[ChurnEvent]] = {}
        for ev in self.events:
            self._by_step.setdefault(ev.step, []).append(ev)

    def events_at(self, step: int) -> list[ChurnEvent]:
        return self._by_step.get(step, [])

    @property
    def horizon(self) -> int:
        """Last step carrying an event (-1 for the empty schedule)."""
        return self.events[-1].step if self.events else -1

    def __len__(self) -> int:
        return len(self.events)

    def __add__(self, other: "ChurnSchedule") -> "ChurnSchedule":
        return ChurnSchedule(self.events + other.events)

    # -- builders -------------------------------------------------------------

    @classmethod
    def leave_rejoin(cls, nodes: Sequence[int], leave_at: int,
                     rejoin_at: int) -> "ChurnSchedule":
        """The headline experiment: ``nodes`` go offline at ``leave_at`` and
        come back (with anti-entropy catch-up) at ``rejoin_at``."""
        if rejoin_at <= leave_at:
            raise ValueError("rejoin_at must come after leave_at")
        nodes = tuple(nodes)
        return cls([ChurnEvent(leave_at, "leave", nodes=nodes),
                    ChurnEvent(rejoin_at, "join", nodes=nodes)])

    @classmethod
    def link_flap(cls, edges: Sequence[tuple[int, int]], down_at: int,
                  up_at: int) -> "ChurnSchedule":
        if up_at <= down_at:
            raise ValueError("up_at must come after down_at")
        edges = tuple((int(u), int(v)) for u, v in edges)
        return cls([ChurnEvent(down_at, "link_down", edges=edges),
                    ChurnEvent(up_at, "link_up", edges=edges)])

    @classmethod
    def partition(cls, groups: Sequence[Sequence[int]], at: int,
                  heal_at: int) -> "ChurnSchedule":
        """Transient partition: every base edge crossing the groups fails at
        ``at`` and is restored (triggering anti-entropy) at ``heal_at``."""
        if heal_at <= at:
            raise ValueError("heal_at must come after at")
        gs = tuple(tuple(int(i) for i in g) for g in groups)
        return cls([ChurnEvent(at, "partition", groups=gs),
                    ChurnEvent(heal_at, "heal")])

    @classmethod
    def random_churn(cls, n: int, steps: int, rate: float, seed: int = 0,
                     outage: tuple[int, int] = (5, 15),
                     max_concurrent: int = 1) -> "ChurnSchedule":
        """Seeded random node churn: each online node leaves with per-step
        probability ``rate`` (at most ``max_concurrent`` offline at once) and
        rejoins after a uniform outage of ``outage`` steps, clamped so every
        node is back online before ``steps``."""
        rng = np.random.default_rng(seed)
        events: list[ChurnEvent] = []
        offline: dict[int, int] = {}            # node -> rejoin step
        for t in range(steps):
            for node, back in list(offline.items()):
                if back == t:
                    events.append(ChurnEvent(t, "join", nodes=(node,)))
                    del offline[node]
            for node in range(n):
                if node in offline or len(offline) >= max_concurrent:
                    continue
                if rng.random() < rate:
                    lo, hi = outage
                    back = t + int(rng.integers(lo, hi + 1))
                    back = min(back, steps - 1)
                    if back <= t:
                        continue
                    events.append(ChurnEvent(t, "leave", nodes=(node,)))
                    offline[node] = back
        # back is always clamped into (t, steps-1], so the matching join was
        # emitted inside the loop — no node can be left offline at the horizon
        assert not offline
        return cls(events)

    @classmethod
    def from_config(cls, cfg) -> "ChurnSchedule":
        """Resolve a declarative ``repro_torch.configs.base.ChurnConfig``."""
        if cfg.kind == "leave_rejoin":
            return cls.leave_rejoin(cfg.nodes, cfg.leave_at, cfg.rejoin_at)
        if cfg.kind == "link_flap":
            return cls.link_flap(cfg.edges, cfg.leave_at, cfg.rejoin_at)
        if cfg.kind == "partition":
            return cls.partition(cfg.groups, cfg.leave_at, cfg.rejoin_at)
        if cfg.kind == "random":
            return cls.random_churn(cfg.n, cfg.steps, cfg.rate, cfg.seed,
                                    cfg.outage, cfg.max_concurrent)
        raise ValueError(f"unknown churn kind '{cfg.kind}'")


@dataclasses.dataclass
class TopologyDelta:
    """What one event (or batch of events) changed — consumed by protocols."""
    left: list[int] = dataclasses.field(default_factory=list)
    joined: list[tuple[int, int | None]] = dataclasses.field(
        default_factory=list)              # (node, sync partner or None)
    downed: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    restored: list[tuple[int, int]] = dataclasses.field(default_factory=list)

    def merge(self, other: "TopologyDelta") -> None:
        self.left += other.left
        self.joined += other.joined
        self.downed += other.downed
        self.restored += other.restored


class DynamicTopology:
    """Mutable membership view over a fixed base graph.

    Nodes are 0..n-1 forever; ``leave``/``join`` toggle whether a node
    participates, ``fail_link``/``restore_link`` toggle base edges, and
    ``partition``/``heal`` fail/restore the cut between node groups.  A
    message-passing edge is *live* iff it is a base edge, not failed, and
    both endpoints are online.
    """

    def __init__(self, graph: nx.Graph):
        if graph.number_of_nodes() == 0:
            raise ValueError("empty graph")
        if not nx.is_connected(graph):
            raise ValueError("SeedFlood assumes a connected communication graph")
        self.base_graph = graph.copy()
        self.n = graph.number_of_nodes()
        self._online = [True] * self.n
        self._down: set[frozenset] = set()
        self._partition_cut: set[frozenset] = set()
        self._dirty = True                  # neighbour lists stale
        self._diam_dirty = True             # effective diameter stale
        self._nbrs: list[list[int]] | None = None
        self._eff_diam: int | None = None
        self.version = 0                    # bumped on every mutation

    # -- queries --------------------------------------------------------------

    def is_active(self, i: int) -> bool:
        return self._online[i]

    def active_mask(self) -> np.ndarray:
        return np.asarray(self._online, dtype=bool)

    def n_active(self) -> int:
        return sum(self._online)

    def edge_live(self, u: int, v: int) -> bool:
        return (self.base_graph.has_edge(u, v)
                and frozenset((u, v)) not in self._down
                and self._online[u] and self._online[v])

    def live_edge_count(self) -> int:
        return sum(1 for u, v in self.base_graph.edges()
                   if self.edge_live(u, v))

    def neighbors(self) -> list[list[int]]:
        """Per-node sorted list of live neighbours (empty for offline nodes)."""
        self._refresh()
        return self._nbrs

    def current_graph(self) -> nx.Graph:
        """All n nodes, only live edges (offline nodes are isolated)."""
        g = nx.Graph()
        g.add_nodes_from(range(self.n))
        g.add_edges_from((u, v) for u, v in self.base_graph.edges()
                         if self.edge_live(u, v))
        return g

    def effective_diameter(self) -> int:
        """Max diameter over connected components of live online nodes — the
        number of flood rounds that guarantees component-wide coverage.
        Cached separately from the neighbour lists: the all-pairs BFS is the
        expensive part and most mutations never ask for it."""
        if self._diam_dirty:
            self._refresh()
            self._eff_diam = self._max_component_diameter()
            self._diam_dirty = False
        return self._eff_diam

    def is_connected(self) -> bool:
        g = self.current_graph()
        online = [i for i in range(self.n) if self._online[i]]
        if not online:
            return False
        return nx.is_connected(g.subgraph(online))

    def _refresh(self) -> None:
        if not self._dirty:
            return
        nbrs: list[list[int]] = [[] for _ in range(self.n)]
        for u, v in self.base_graph.edges():
            if self.edge_live(u, v):
                nbrs[u].append(v)
                nbrs[v].append(u)
        self._nbrs = [sorted(ns) for ns in nbrs]
        self._dirty = False

    def _max_component_diameter(self) -> int:
        g = self.current_graph()
        online = [i for i in range(self.n) if self._online[i]]
        diam = 0
        if online:
            sub = g.subgraph(online)
            for comp in nx.connected_components(sub):
                if len(comp) > 1:
                    diam = max(diam, nx.diameter(sub.subgraph(comp)))
        return diam

    # -- mutations ------------------------------------------------------------

    def _mutated(self) -> None:
        self._dirty = True
        self._diam_dirty = True
        self.version += 1

    def leave(self, i: int) -> None:
        if not self._online[i]:
            raise ValueError(f"node {i} is already offline")
        self._online[i] = False
        self._mutated()

    def join(self, i: int) -> int | None:
        """Bring node ``i`` back online; returns the lowest-id live neighbour
        (the anti-entropy sync partner) or None if it rejoins isolated."""
        if self._online[i]:
            raise ValueError(f"node {i} is already online")
        self._online[i] = True
        self._mutated()
        self._refresh()
        ns = self._nbrs[i]
        return ns[0] if ns else None

    def fail_link(self, u: int, v: int) -> None:
        if not self.base_graph.has_edge(u, v):
            raise ValueError(f"({u},{v}) is not a base edge")
        self._down.add(frozenset((u, v)))
        self._mutated()

    def restore_link(self, u: int, v: int) -> bool:
        """Returns True if the link was actually down (and is now restored)."""
        e = frozenset((u, v))
        if e in self._down:
            self._down.discard(e)
            self._partition_cut.discard(e)
            self._mutated()
            return True
        return False

    def partition(self, groups: Sequence[Sequence[int]]) -> list[tuple[int, int]]:
        """Fail every live base edge crossing the groups; remembers the cut so
        ``heal`` can restore exactly it."""
        side = {}
        for gi, g in enumerate(groups):
            for node in g:
                side[node] = gi
        cut = []
        for u, v in self.base_graph.edges():
            if side.get(u) is not None and side.get(v) is not None \
                    and side[u] != side[v] \
                    and frozenset((u, v)) not in self._down:
                self._down.add(frozenset((u, v)))
                self._partition_cut.add(frozenset((u, v)))
                cut.append((u, v))
        self._mutated()
        return cut

    def heal(self) -> list[tuple[int, int]]:
        restored = []
        for e in sorted(self._partition_cut, key=sorted):
            u, v = sorted(e)
            self._down.discard(e)
            restored.append((u, v))
        self._partition_cut.clear()
        self._mutated()
        return restored

    # -- checkpointing ---------------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-serializable membership state (the base graph is rebuilt
        from config at resume, so only the mutable overlay is captured)."""
        return {
            "online": [bool(x) for x in self._online],
            "down": sorted(sorted(e) for e in self._down),
            "partition_cut": sorted(sorted(e) for e in self._partition_cut),
        }

    def load_state_dict(self, state: dict) -> None:
        self._online = [bool(x) for x in state["online"]]
        self._down = {frozenset((int(u), int(v)))
                      for u, v in state["down"]}
        self._partition_cut = {frozenset((int(u), int(v)))
                               for u, v in state["partition_cut"]}
        self._mutated()

    # -- event application ----------------------------------------------------

    def apply_event(self, ev: ChurnEvent) -> TopologyDelta:
        d = TopologyDelta()
        if ev.kind == "leave":
            for i in ev.nodes:
                self.leave(i)
                d.left.append(i)
        elif ev.kind == "join":
            for i in ev.nodes:
                d.joined.append((i, self.join(i)))
        elif ev.kind == "link_down":
            for u, v in ev.edges:
                self.fail_link(u, v)
                d.downed.append((u, v))
        elif ev.kind == "link_up":
            for u, v in ev.edges:
                if self.restore_link(u, v):
                    d.restored.append((u, v))
        elif ev.kind == "partition":
            d.downed += self.partition(ev.groups)
        elif ev.kind == "heal":
            d.restored += self.heal()
        return d

    def apply_events(self, events: Iterable[ChurnEvent]) -> TopologyDelta:
        d = TopologyDelta()
        for ev in events:
            d.merge(self.apply_event(ev))
        return d
