"""Deterministic discrete-event core of the asynchronous simulator (a copy
of the JAX package's ``repro/sim/events.py``; pure Python).

A priority queue of timestamped events — no real clocks anywhere, so a run
is a pure function of its config and bitwise reproducible.  Three event
kinds, ranked at equal virtual time:

    STEP(0) < DELIVER(1) < CHURN(2)

* ``STEP``    — a client finishes the compute of local step ``step`` (the
  serve swarm: a trainer tick, or one server's decode-step boundary).
* ``DELIVER`` — a batch of flood messages arrives at ``client`` over the
  edge from ``sender``, ``gen`` hops from its emission.  DELIVER outranks
  CHURN so a zero-latency delivery lands before a same-timestamp topology
  mutation.
* ``CHURN``   — a :class:`~repro_torch.topology.dynamic.ChurnSchedule` step
  index mapped onto virtual time.  Ranked last so the work completing at
  the same timestamp still ran on the pre-mutation topology.

**Tiebreak rule.** The heap is keyed on the *content* tuple
``(time, rank, step, gen, sender, client)`` with an insertion sequence
number as the final component.  Content fields order everything the
synchronous oracle orders (round structure via ``gen``, the per-round
``for i in range(n)`` send order via ``sender``); the sequence number only
separates events whose content coincides — and those are only ever pushed
by an earlier, already fully key-ordered cascade, so pop order is
independent of the order initial events were inserted.
"""
from __future__ import annotations

import dataclasses
import heapq

RANK_STEP = 0
RANK_DELIVER = 1
RANK_CHURN = 2


@dataclasses.dataclass(frozen=True)
class Event:
    time: float
    rank: int
    client: int = -1       # STEP: stepping client; DELIVER: destination
    step: int = -1         # STEP / CHURN: step index
    gen: int = 0           # DELIVER: flood hop generation (1 = first hop)
    sender: int = -1       # DELIVER: forwarding client
    msgs: tuple = ()       # DELIVER: Message batch, emission-ordered
    client_gen: int = 0    # STEP: churn generation; stale events are skipped

    def key(self) -> tuple:
        return (self.time, self.rank, self.step, self.gen, self.sender,
                self.client)


def step_event(time: float, client: int, step: int,
               client_gen: int = 0) -> Event:
    return Event(time=time, rank=RANK_STEP, client=client, step=step,
                 client_gen=client_gen)


def deliver_event(time: float, dst: int, sender: int, gen: int,
                  msgs: tuple) -> Event:
    return Event(time=time, rank=RANK_DELIVER, client=dst, sender=sender,
                 gen=gen, msgs=msgs)


def churn_event(time: float, step: int) -> Event:
    return Event(time=time, rank=RANK_CHURN, step=step)


class EventQueue:
    """Min-heap over :meth:`Event.key` with an insertion-sequence tiebreak."""

    def __init__(self):
        self._heap: list[tuple[tuple, int, Event]] = []
        self._seq = 0

    def push(self, ev: Event) -> None:
        heapq.heappush(self._heap, (ev.key(), self._seq, ev))
        self._seq += 1

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[2]

    def peek(self) -> Event | None:
        return self._heap[0][2] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
