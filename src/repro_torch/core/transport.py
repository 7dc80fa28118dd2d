"""Transport plugins: the communication half of the Method × Transport API
(the port of ``repro/core/transport.py``).

A transport owns the network substrate (flood engine, mixing matrix, or
nothing), the churn response (anti-entropy catch-up, live-subgraph
reweighting) and the :class:`~repro_torch.core.messages.CommLedger`.  Byte
accounting lives here and nowhere else: a method never sees the ledger, so
the paper's cost metric cannot drift between methods.

* :class:`FloodTransport`    — seed–scalar flooding (``core.flood``) with a
  ``k``-hop budget per step, anti-entropy catch-up after churn and an
  end-of-run drain.
* :class:`GossipTransport`   — mixing-matrix parameter exchange every
  ``every`` steps, optionally through Choco compressed differences; under
  churn the mixing matrix shrinks to the live subgraph.
* :class:`GossipSRTransport` — the §3.2 strawman: full seed–scalar
  histories across every edge, averaged under the mixing matrix.
* :class:`NullTransport`     — no communication (the centralized oracle).

Each transport's state is checkpointable (``state_arrays``, ``state_meta``,
``load_state``) in the JAX package's layout.  ``exchange``'s ``active``
mask is the live clients (None = all online).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.core import flood, gossip, messages
from repro_torch.core.messages import MESSAGE_BYTES, CommLedger
from repro_torch.models import params as plib
from repro_torch.topology import graphs
from repro_torch.topology.dynamic import DynamicTopology


@dataclasses.dataclass
class FloodInbox:
    """One step's newly delivered payloads as dense padded ``(n, K)``
    seed / coef / sender-step matrices, and the receiver step ``t`` (only
    the ``epoch_replay=False`` regression arm reads it)."""
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

    def apply_churn(self, events) -> None:
        raise ValueError(f"{type(self).__name__} does not support churn")

    def drain(self, max_iters: int, final_step: int) -> Iterator[Any]:
        """Nothing in flight: the end-of-run drain yields no inbox."""
        return iter(())

    def stats(self) -> dict:
        return {}

    # -- checkpointing --------------------------------------------------------

    def state_arrays(self) -> dict | None:
        """Array-valued tree of transport state (None when stateless)."""
        return None

    def state_meta(self) -> dict:
        return {"ledger": dataclasses.asdict(self.ledger)}

    def load_state(self, arrays: Any, meta: dict) -> None:
        for k, v in meta.get("ledger", {}).items():
            setattr(self.ledger, k, int(v))


class FloodTransport(TransportBase):
    """Seed–scalar flooding over a (churnable) overlay graph, with a
    ``flood_k`` hop budget per step (None = full flooding over the live
    effective diameter) and an end-of-run drain, over the engine
    ``flood.make_network`` picks for ``backend``.  The anti-entropy
    catch-up that churn produces at the start of a step is prepended to
    that step's payloads."""

    def __init__(self, graph, *, backend: str = "auto",
                 flood_k: int | None = None):
        self.net = flood.make_network(graph, backend=backend)
        self.n = self.net.n
        self.flood_k = flood_k
        self._pending = None          # anti-entropy catch-up, per-client arrays
        self._ck_meta = None

    @property
    def ledger(self) -> CommLedger:
        return self.net.ledger

    def active_mask(self) -> np.ndarray:
        return self.net.active_mask()

    def apply_churn(self, events) -> None:
        self.net.apply_churn(events)
        self._pending = self.net.drain_catchup_arrays()

    def exchange(self, payload, t: int,
                 active: np.ndarray | None = None) -> FloodInbox:
        for i, msg in payload:
            self.net.inject(i, msg)
        # full flooding tracks the effective diameter, which churn moves
        k_hops = self.flood_k if self.flood_k is not None else self.net.diameter
        sds, cfs, stp = self.net.rounds_padded(k_hops, extra=self._pending)
        self._pending = None
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
                "sync_bytes": self.ledger.sync_bytes,
                "n_syncs": self.ledger.n_syncs,
                "engine": type(self.net).__name__}

    # serializing the network builds the whole message table and seen-set
    # dump; the Trainer calls state_arrays then state_meta per checkpoint,
    # so the first call keeps the (arrays, meta) pair's meta for the second

    def state_arrays(self) -> dict:
        arrays, self._ck_meta = self.net.state_dict()
        return arrays

    def state_meta(self) -> dict:
        net_meta = self._ck_meta
        if net_meta is None:
            net_meta = self.net.state_dict()[1]
        self._ck_meta = None
        return {**super().state_meta(), "net": net_meta}

    def load_state(self, arrays, meta) -> None:
        super().load_state(arrays, meta)
        self.net.load_state_dict(arrays, meta["net"])
        self._pending = None


class GossipTransport(TransportBase):
    """Mixing-matrix parameter exchange, optionally Choco-compressed.

    ``exchange`` fires every ``every`` steps (``local_iters``) and returns
    the mixed trainable dict; other steps return None.  Under churn the
    mixing matrix is the Metropolis matrix of the live subgraph (an offline
    client's row is e_i) and only live edges are charged.  With
    ``choco_density`` set, differences are top-k compressed through
    per-client surrogate copies whose state lives here (communication
    state, not method state), checkpointed as ``x_hat``."""

    def __init__(self, graph, W: np.ndarray, *, every: int,
                 choco_density: float | None = None,
                 churn_aware: bool = False):
        self.topo = DynamicTopology(graph)
        self.n = self.topo.n
        self.W = W
        self.every = every
        self.density = choco_density
        self.churn_aware = churn_aware
        self.live_edges = graph.number_of_edges()
        self.ledger = CommLedger(n_edges=graph.number_of_edges())
        self._choco = None

    def bind(self, init_payload) -> None:
        if self.density is not None:
            # paper App. B.2: surrogates start at the pretrained weights
            self._choco = gossip.choco_init(init_payload)

    def active_mask(self) -> np.ndarray:
        return self.topo.active_mask()

    def apply_churn(self, events) -> None:
        # gossip has no anti-entropy: the mixing matrix just shrinks
        self.topo.apply_events(events)
        self.W = graphs.metropolis_weights(self.topo.current_graph())
        self.live_edges = self.topo.live_edge_count()

    def exchange(self, trainable: dict, t: int,
                 active: np.ndarray | None = None):
        if (t + 1) % self.every != 0:
            return None
        floats_per_client = sum(v.numel() for v in trainable.values()) // self.n
        if self.density is not None:
            # offline clients' innovations are masked whenever anyone is
            # offline (with every client online the mask is a bitwise no-op)
            use_active = active is not None and (self.churn_aware
                                                 or not active.all())
            trainable, self._choco = gossip.choco_round(
                trainable, self._choco, self.W, self.density,
                active=active if use_active else None)
            self.ledger.send(2 * self.live_edges * messages.topk_payload_bytes(
                floats_per_client, self.density))
        else:
            trainable = gossip.mix(trainable, self.W)
            self.ledger.send(2 * self.live_edges * messages.dense_payload_bytes(
                floats_per_client))
        return trainable

    def state_arrays(self):
        return {"x_hat": self._choco.x_hat} if self._choco is not None else None

    def state_meta(self) -> dict:
        return {**super().state_meta(),
                "topo": self.topo.state_dict(),
                "live_edges": self.live_edges,
                "W": np.asarray(self.W, np.float64).tolist()}

    def load_state(self, arrays, meta) -> None:
        super().load_state(arrays, meta)
        self.topo.load_state_dict(meta["topo"])
        self.live_edges = int(meta["live_edges"])
        self.W = np.asarray(meta["W"], np.float64)
        if self.density is not None:
            x = (arrays or {}).get("x_hat")
            if x is None:
                raise ValueError("choco checkpoint is missing the surrogate "
                                 "copies (x_hat)")
            # the surrogates bound at init give each leaf's device and dtype
            bound = self._choco.x_hat
            self._choco = gossip.ChocoState(x_hat={
                p: torch.as_tensor(v, dtype=bound[p].dtype,
                                   device=bound[p].device)
                for p, v in plib.flatten(x).items()})


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
