"""The event-driven counterpart of the synchronous Trainer (the port of
``repro/sim/event_trainer.py``; DESIGN.md §9).

Same Method, same Setup, same RunResult — only the clock changes: instead
of ``for t in range(steps)`` with a barrier per step, a discrete-event loop
pops ``STEP < DELIVER < CHURN`` events off a virtual-time priority queue.
Each client steps at its own trace rate; flood messages arrive per edge
after propagation + serialization delay and are folded in through the same
epoch-grouped ``apply_inbox`` the synchronous loop uses (the sender-step
replay of DESIGN.md §3 is what makes arbitrarily stale arrival exact).

Clients finishing the same step at the same virtual time form a *cohort*
processed as one batched dispatch over every row of the stacked params.
With a homogeneous zero-latency trace every cohort is the full swarm and
the run reproduces the synchronous Trainer bitwise (loss curve, byte
ledger and final parameters; ``tests/test_torch_sim.py``); heterogeneous
traces degrade gracefully to per-client cohorts through the same kernels.

Method contracts are reused, not extended:

* the ``active`` argument of ``local_step`` carries a float weight vector —
  1.0 on cohort members plus the ``n_online - |cohort|`` remainder on the
  lowest cohort member, so SeedFlood's ``n_eff = sum(active)`` equals the
  online population exactly (integer-valued floats, exact sums) while
  non-cohort rows keep zero weight and stay bitwise frozen;
* gossip methods get the plain boolean cohort mask (their freeze guard
  already handles partial masks) and mixing stays a barrier — clients wait
  at mix steps, run free between them.

Churn schedules are defined on step indices; the event loop maps index
``T`` to virtual time ``T * ref`` (``ref`` = ``sim_churn_step_s`` or the
trace's median step time), ranked after same-time STEP/DELIVER events so
the cohort completing at that instant still ran pre-mutation — the
synchronous "churn lands at the start of the step" ordering.

The run always drains: after the last cohort, trailing flood frontiers are
released and every delivered message applied, so the final model state is
the fully-mixed one (compare with ``drain=True`` synchronous runs).

Virtual time is Python floats, computed in the reference's order, so it
equals the JAX package's exactly.  ``extra`` carries ``virtual_time_s``,
``loss_vs_virtual_time`` (one ``(time, loss)`` per cohort), an empty
``step_wall_s`` (a cohort is not a step), and, as the synchronous Trainer
reports them, ``valid_loss`` and ``final_stacked``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.dtrain.api import RunResult, Setup, active_consensus, \
    log_step_loss
from repro_torch.sim import events
from repro_torch.sim.async_transport import AsyncFloodTransport
from repro_torch.sim.events import EventQueue
from repro_torch.sim.traces import TraceSet
from repro_torch.topology.dynamic import ChurnSchedule


class EventTrainer:
    """Drives one trace-clocked asynchronous run of ``method``."""

    def __init__(self, cfg, setup: Setup, method, transport,
                 trace: TraceSet, churn: ChurnSchedule | None = None,
                 init_order=None):
        if churn is not None and not isinstance(transport, AsyncFloodTransport):
            raise ValueError("event-driven churn needs the flood substrate "
                             "(gossip mixing is a barrier over all clients)")
        self.cfg = cfg
        self.setup = setup
        self.method = method
        self.transport = transport
        self.trace = trace
        self.churn = churn
        # initial-event insertion order; results must not depend on it
        # (tests permute it) — kept as a knob only for that test.
        self.init_order = list(init_order) if init_order is not None \
            else list(range(cfg.n_clients))

    # -- helpers ---------------------------------------------------------------

    def _maybe_eval(self, idx: int, state) -> None:
        """Eval cadence on step *indices*: index ``t`` fires once the swarm
        reaches step ``t`` — the synchronous eval at the end of step
        ``t - 1`` — regardless of the virtual time that took."""
        ee = self.cfg.eval_every
        if not ee or idx == 0 or idx % ee or idx in self._evaluated:
            return
        self._evaluated.add(idx)
        stacked = self.method.params_of(state)
        self._acc_curve.append((idx, self.setup.gmp(stacked)))
        self._consensus_curve.append(
            (idx, active_consensus(stacked, self.transport.active_mask())))

    def _pop_cohort(self, first: events.Event, q: EventQueue,
                    gen: list[int]) -> list[int]:
        """Coalesce every queued STEP event sharing ``(time, step)`` with
        ``first`` (stale generations dropped) — one batched dispatch."""
        cohort = [first.client]
        while True:
            nxt = q.peek()
            if (nxt is None or nxt.rank != events.RANK_STEP
                    or nxt.time != first.time or nxt.step != first.step):
                break
            nxt = q.pop()
            if nxt.client_gen == gen[nxt.client]:
                cohort.append(nxt.client)
        return sorted(cohort)

    def _schedule_step(self, q: EventQueue, i: int, t: int, now: float,
                       gen: list[int], next_step: list[int]) -> None:
        if t < self.cfg.steps:
            finish = self.trace.finish_time(i, now,
                                            self.trace.compute_time(i, t))
            q.push(events.step_event(finish, i, t, gen[i]))
        next_step[i] = t

    def _apply_churn(self, ev: events.Event, q: EventQueue, state,
                     gen: list[int], next_step: list[int]):
        """Map one churn step index onto the live topology.  Before mutating,
        every delivered-but-unapplied message is folded in: the synchronous
        loop applied the previous step's exchange before this churn fired,
        and a departing node must not take an unapplied inbox offline."""
        inbox = self.transport.pop_inbox(list(range(self.cfg.n_clients)),
                                         ev.step)
        if inbox is not None:
            state = self.method.apply_inbox(state, inbox)
        before = np.array(self.transport.active_mask(), bool)
        self.transport.apply_churn(self.churn.events_at(ev.step))
        after = np.array(self.transport.active_mask(), bool)
        for i in np.flatnonzero(before & ~after):
            gen[int(i)] += 1           # cancel the in-flight STEP event
        for i in np.flatnonzero(after & ~before):
            i = int(i)
            gen[i] += 1
            # a rejoiner resumes at the current virtual step — never re-runs
            # steps it already took, never back-fills steps it slept through
            self._schedule_step(q, i, max(next_step[i], ev.step), ev.time,
                                gen, next_step)
        return state

    # -- the loop --------------------------------------------------------------

    def run(self) -> RunResult:
        cfg, s, method, transport = self.cfg, self.setup, self.method, \
            self.transport
        n = cfg.n_clients
        state = method.init(s)
        transport.bind(method.initial_payload(state))
        t0 = time.time()                # reporting only; no RNG reads clocks

        loss_curve: list[float] = []
        self._acc_curve: list[tuple[int, float]] = []
        self._consensus_curve: list[tuple[int, float]] = []
        self._evaluated: set[int] = set()
        loss_vs_vtime: list[tuple[float, float]] = []

        q = EventQueue()
        gen = [0] * n
        next_step = [0] * n
        for i in self.init_order:
            self._schedule_step(q, i, 0, 0.0, gen, next_step)
        if self.churn is not None:
            ref = cfg.sim_churn_step_s or self.trace.ref_step_s
            for T in sorted({ev.step for ev in self.churn.events}):
                q.push(events.churn_event(T * ref, T))

        is_flood = isinstance(transport, AsyncFloodTransport)
        done: dict[int, set[int]] = {}      # gossip barrier bookkeeping
        last_payload = None
        now = 0.0

        while q:
            ev = q.pop()
            now = ev.time
            if ev.rank == events.RANK_CHURN:
                state = self._apply_churn(ev, q, state, gen, next_step)
                continue
            if ev.rank == events.RANK_DELIVER:
                transport.deliver(ev, q)
                continue
            if ev.client_gen != gen[ev.client]:
                continue                    # cancelled by churn
            cohort = self._pop_cohort(ev, q, gen)
            t = ev.step

            if is_flood:
                inbox = transport.pop_inbox(cohort, t)
                if inbox is not None:
                    state = method.apply_inbox(state, inbox)
                self._maybe_eval(t, state)

                mask = np.array(transport.active_mask(), bool)
                w = np.zeros(n, np.float64)
                w[cohort] = 1.0
                w[cohort[0]] += max(int(mask.sum()) - len(cohort), 0)
                state, outbox = method.local_step(state, s.batches(t), w, t)
                cmask = np.zeros(n, bool)
                cmask[cohort] = True
                log_step_loss(loss_curve, np.asarray(outbox.losses),
                              cmask[:len(outbox.losses)])
                loss_vs_vtime.append((now, loss_curve[-1]))

                for i, msg in outbox.payload:
                    transport.emit(i, msg, now, q)
                for i in cohort:
                    transport.release(i, now, q)
                transport.merge_deferred(cohort)
                for i in cohort:
                    self._schedule_step(q, i, t + 1, now, gen, next_step)
            else:
                cmask = np.zeros(n, bool)
                cmask[cohort] = True
                state, outbox = method.local_step(state, s.batches(t),
                                                  cmask, t)
                log_step_loss(loss_curve, np.asarray(outbox.losses),
                              cmask[:len(outbox.losses)])
                loss_vs_vtime.append((now, loss_curve[-1]))
                last_payload = outbox.payload
                done.setdefault(t, set()).update(cohort)

                if (t + 1) % transport.every:
                    for i in cohort:
                        self._schedule_step(q, i, t + 1, now, gen, next_step)
                    if len(done[t]) == n:
                        self._maybe_eval(t + 1, state)
                else:
                    # mixing is a barrier: finished clients idle at the mix
                    # point until the last straggler's step-t model exists
                    for i in cohort:
                        next_step[i] = t + 1
                    if len(done[t]) == n:
                        mixed, delay = transport.mix(
                            last_payload, t, transport.active_mask())
                        # the pre-mix models are a stacked copy: drop them
                        last_payload = None
                        state = method.apply_inbox(state, mixed)
                        self._maybe_eval(t + 1, state)
                        for i in range(n):
                            self._schedule_step(q, i, t + 1, now + delay,
                                                gen, next_step)

        if is_flood:
            # always drain: release trailing frontiers until quiescent, then
            # fold in everything still delivered-but-unapplied
            while transport.final_release(now, q):
                while q:
                    ev = q.pop()
                    now = ev.time
                    if ev.rank == events.RANK_DELIVER:
                        transport.deliver(ev, q)
            inbox = transport.final_flush(cfg.steps)
            if inbox is not None:
                state = method.apply_inbox(state, inbox)
        self._maybe_eval(cfg.steps, state)
        if s.device.type == "cuda":
            torch.cuda.synchronize(s.device)

        mask = transport.active_mask()
        stacked = method.params_of(state)
        stats = transport.stats()
        extra = {"n_params": s.n_params, **stats,
                 "valid_loss": s.valid_loss(stacked),
                 "consensus_curve": self._consensus_curve,
                 "step_wall_s": [],
                 "virtual_time_s": now,
                 "loss_vs_virtual_time": loss_vs_vtime,
                 "final_stacked": stacked,
                 **method.result_extra(state)}
        return RunResult(
            method=method.label(stats), gmp=s.gmp(stacked),
            loss_curve=loss_curve, acc_curve=self._acc_curve,
            bytes_per_edge=transport.ledger.per_edge,
            total_bytes=transport.ledger.total_bytes,
            consensus_error=active_consensus(stacked, mask),
            wall_s=time.time() - t0, extra=extra)


def barrier_schedule(trace: TraceSet, steps: int) -> list[float]:
    """Per-step completion times of the synchronous-barrier baseline on the
    same trace: every step waits for the slowest client (episodes included)."""
    times = []
    now = 0.0
    for t in range(steps):
        now = max(trace.finish_time(i, now, trace.compute_time(i, t))
                  for i in range(trace.n))
        times.append(now)
    return times


def time_to_loss(curve: list[tuple[float, float]], target: float) -> float:
    """First virtual time at which the running-min loss crosses ``target``
    (``inf`` if never) — the wall-clock-to-loss metric of an async run."""
    best = float("inf")
    for vt, loss in curve:
        best = min(best, loss)
        if best <= target:
            return vt
    return float("inf")
