"""Async adapters over the synchronous Transport plugins (the port of
``repro/sim/async_transport.py``; DESIGN.md §9).

Methods are untouched and byte accounting stays inside transports.  These
adapters replace the round-synchronous ``exchange`` with timestamped
per-edge delivery:

* :class:`AsyncFloodTransport` wraps a :class:`~repro_torch.core.transport.
  FloodTransport`'s per-message :class:`~repro_torch.core.flood.
  FloodNetwork` (the bitset engine is round-synchronous by construction and
  is rejected).  Emission floods hop by hop: each accepted batch is
  forwarded to every live neighbour as a DELIVER event delayed by the
  trace's propagation + serialization formula over exactly the bytes the
  ledger charges.  The per-(gen, sender) event ordering reproduces the
  synchronous round structure, so with a homogeneous zero-latency trace the
  pending-inbox sequence each client applies is bitwise the synchronous one.
* :class:`AsyncGossipTransport` wraps a :class:`~repro_torch.core.
  transport.GossipTransport`: mixing is inherently a barrier, so the
  EventTrainer waits for every client to finish step ``t`` before mixing;
  the adapter charges the ledger through the wrapped ``exchange`` and
  converts the charged bytes into one mix delay.

Anti-entropy catch-up after churn lands in a *deferred* buffer that is
merged into a client's pending inbox only after its same-timestamp cohort
has applied + stepped — the synchronous loop's "catch-up rides in this
step's exchange" ordering.  The re-flood of caught-up messages sits in the
node's frontier and is released at its next emission, ahead of its fresh
message, matching the synchronous round-1 frontier order.

The message order of a pending inbox is the order in which the replay sums
the messages into the weights, so it is kept exactly: arrival order, each
batch deduplicated against the seen-set before it is appended, the deferred
catch-up put in front.  Nothing here touches a tensor.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import flood
from repro_torch.core.messages import MESSAGE_BYTES
from repro_torch.core.transport import (FloodInbox, FloodTransport,
                                        GossipTransport, TransportBase)
from repro_torch.sim import events
from repro_torch.sim.events import EventQueue
from repro_torch.sim.traces import TraceSet


class AsyncFloodTransport(TransportBase):
    """Timestamped per-edge flooding over the per-message flood engine."""

    kind = "flood"

    def __init__(self, inner: FloodTransport, trace: TraceSet,
                 extra_latency_s: float = 0.0):
        if not isinstance(inner.net, flood.FloodNetwork):
            raise ValueError(
                "the event engine needs the per-message flood engine; set "
                "flood_backend='python' (the numpy bitset engine is "
                "round-synchronous)")
        if inner.flood_k is not None:
            raise ValueError("flood_k has no meaning under per-edge "
                             "timestamped delivery")
        self.inner = inner
        self.net: flood.FloodNetwork = inner.net
        self.n = self.net.n
        self.trace = trace
        self.extra_latency_s = extra_latency_s
        # delivered-but-unapplied messages, in arrival order (float-sum order)
        self._pending: list[list] = [[] for _ in range(self.n)]
        # anti-entropy catch-up awaiting the post-cohort merge
        self._deferred: list[list] = [[] for _ in range(self.n)]

    @property
    def ledger(self):
        return self.net.ledger

    def active_mask(self) -> np.ndarray:
        return self.net.active_mask()

    def stats(self) -> dict:
        return self.inner.stats()

    # -- emission / delivery ---------------------------------------------------

    def emit(self, client: int, msg, now: float, queue: EventQueue) -> None:
        """A client's fresh message enters its own frontier (Algorithm 1
        block (C) — it already applied the update locally)."""
        del now, queue
        self.net.inject(client, msg)

    def release(self, client: int, now: float, queue: EventQueue) -> None:
        """Flush the client's frontier — queued anti-entropy re-floods first,
        then fresh injections — to all live neighbours as gen-1 deliveries."""
        st = self.net.states[client]
        if not st.frontier:
            return
        frontier, st.frontier = st.frontier, []
        self._forward(client, frontier, 1, now, queue)

    def _forward(self, src: int, msgs: list, gen: int, now: float,
                 queue: EventQueue) -> None:
        nbytes = len(msgs) * MESSAGE_BYTES
        batch = tuple(msgs)
        for j in self.net.topo.neighbors()[src]:
            self.net.ledger.send(nbytes, count=len(msgs))
            delay = self.trace.edge_delay(src, j, nbytes, self.extra_latency_s)
            queue.push(events.deliver_event(now + delay, dst=j, sender=src,
                                            gen=gen, msgs=batch))

    def deliver(self, ev: events.Event, queue: EventQueue) -> None:
        """Accept a delivery: dedup against S_i, append survivors to the
        pending inbox, and forward them one hop further.  Messages to an
        offline node or over a dead edge are lost in flight (anti-entropy
        recovers them on rejoin/heal)."""
        dst, topo = ev.client, self.net.topo
        if not topo.is_active(dst) or not topo.edge_live(ev.sender, dst):
            return
        st = self.net.states[dst]
        fresh = []
        for m in ev.msgs:
            if m.uid in st.seen:
                continue
            st.seen.add(m.uid)
            st.store[m.uid] = m
            self._pending[dst].append(m)
            fresh.append(m)
        if not fresh:
            return
        if ev.gen >= self.net.diameter:
            # hop budget: the synchronous engine floods `diameter` rounds
            # per exchange, so a last-hop accept waits in the frontier until
            # the node's next release (and is dropped uncharged if the node
            # departs first) — mirrored exactly, ledgers included
            st.frontier.extend(fresh)
        else:
            self._forward(dst, fresh, ev.gen + 1, ev.time, queue)

    # -- inbox / churn ---------------------------------------------------------

    def pop_inbox(self, cohort: list[int], t: int) -> FloodInbox | None:
        """Drain the cohort's pending messages into the padded ``(n, K)``
        matrices of the batched replay (non-cohort rows are zero-coefficient
        padding — exact no-ops)."""
        take = set(cohort)
        payloads = []
        for i in range(self.n):
            if i in take and self._pending[i]:
                f, self._pending[i] = self._pending[i], []
                payloads.append(
                    (np.asarray([m.seed for m in f], np.uint32),
                     np.asarray([m.coef for m in f], np.float32),
                     np.asarray([m.step for m in f], np.int32)))
            else:
                payloads.append((np.zeros(0, np.uint32),
                                 np.zeros(0, np.float32),
                                 np.zeros(0, np.int32)))
        sds, cfs, stp = flood.pad_payloads(payloads)
        if sds.shape[1] == 0:
            return None
        return FloodInbox(sds, cfs, stp, t)

    def apply_churn(self, evs) -> None:
        self.net.apply_churn(evs)
        for dst, msgs in enumerate(self.net.drain_catchup()):
            self._deferred[dst].extend(msgs)

    def merge_deferred(self, cohort: list[int]) -> None:
        """After a cohort applied + stepped, its anti-entropy catch-up joins
        the pending inbox — ahead of later deliveries, like the synchronous
        exchange prepends catch-up to the same step's padded matrices."""
        for i in cohort:
            if self._deferred[i]:
                self._pending[i] = self._deferred[i] + self._pending[i]
                self._deferred[i] = []

    # -- end of run ------------------------------------------------------------

    def final_release(self, now: float, queue: EventQueue) -> bool:
        """Release every still-queued frontier (trailing re-flood hops the
        synchronous engine charges in its next exchange or drain); returns
        whether anything was forwarded."""
        released = False
        for i in range(self.n):
            if self.net.topo.is_active(i) and self.net.states[i].frontier:
                self.release(i, now, queue)
                released = True
        return released

    def final_flush(self, final_step: int) -> FloodInbox | None:
        """Merge all deferred catch-up and drain every pending inbox — the
        event run always ends fully drained (every delivered message applied)."""
        self.merge_deferred(list(range(self.n)))
        return self.pop_inbox(list(range(self.n)), final_step)


class AsyncGossipTransport(TransportBase):
    """Barrier-mixing adapter: gossip averaging needs every client's step-t
    model, so mixes stay synchronization points; between mixes clients run
    free at their trace rates."""

    kind = "gossip"

    def __init__(self, inner: GossipTransport, trace: TraceSet,
                 extra_latency_s: float = 0.0):
        self.inner = inner
        self.trace = trace
        self.extra_latency_s = extra_latency_s
        self.every = inner.every

    @property
    def ledger(self):
        return self.inner.ledger

    def bind(self, init_payload) -> None:
        self.inner.bind(init_payload)

    def active_mask(self) -> np.ndarray:
        return self.inner.active_mask()

    def stats(self) -> dict:
        return self.inner.stats()

    def mix(self, payload, t: int, active: np.ndarray):
        """One mixing round through the wrapped transport; returns the mixed
        trainable dict and the virtual mix delay derived from the bytes it
        charged:

            2 * max latency + extra + per_edge_bytes * 8 / min bandwidth
        """
        before = self.inner.ledger.total_bytes
        mixed = self.inner.exchange(payload, t, active)
        sent = self.inner.ledger.total_bytes - before
        per_edge = sent / max(self.inner.live_edges, 1)
        bw = min(self.trace.bandwidth_bps)
        ser = 0.0 if bw == float("inf") else per_edge * 8.0 / bw
        delay = 2.0 * max(self.trace.latency_s) + self.extra_latency_s + ser
        return mixed, delay


def wrap_async(transport, trace: TraceSet, extra_latency_s: float = 0.0):
    """Wrap a synchronous Transport in its async adapter (the EventTrainer's
    transport argument)."""
    if isinstance(transport, FloodTransport):
        return AsyncFloodTransport(transport, trace, extra_latency_s)
    if isinstance(transport, GossipTransport):
        return AsyncGossipTransport(transport, trace, extra_latency_s)
    raise ValueError(f"{type(transport).__name__} has no async adapter "
                     "(event-driven runs support the flood and gossip "
                     "substrates)")
