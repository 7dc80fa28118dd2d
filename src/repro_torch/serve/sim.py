"""Churn-tolerant serving swarm on the virtual clock (the port of
``repro/serve/sim.py``).

Trainer nodes flood one SubCGE message each per virtual train step through
a real :class:`~repro_torch.core.transport.FloodTransport` (bytes charged
to its CommLedger); server nodes run
:class:`~repro_torch.serve.server.DecodeServer` steps at their own cadence,
folding whatever the flood has delivered at each decode-step boundary.  A
step-indexed :class:`~repro_torch.topology.dynamic.ChurnSchedule` (mapped
onto virtual time by ``TRAIN_PERIOD``) takes servers offline mid-decode:
*leave* suspends their in-flight requests back onto the queue, *join*
re-admits them through the normal admission path — pages re-reserved from
the free list, KV rebuilt by re-prefill — while the bridge catches the
weights up from the transport's anti-entropy.

No wall clocks anywhere: a run is a pure function of (configs, request
script, churn schedule), so running it twice yields identical token
streams and byte ledgers.  Every server holds its own copy of the initial
weights (the fold writes them in place), on ``device`` (default the card).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.messages import Message
from repro_torch.core.seeds import client_seeds
from repro_torch.core.transport import FloodTransport
from repro_torch.models import transformer as tf
from repro_torch.serve.bridge import LiveUpdateBridge
from repro_torch.serve.scheduler import Request, ServeConfig
from repro_torch.serve.server import DecodeServer, resolve_device
from repro_torch.sim.events import RANK_CHURN, EventQueue, churn_event, \
    step_event
from repro_torch.topology import graphs

#: ``client`` id carried by the collective trainer-tick STEP event.
TRAINER_TICK = -1
#: Virtual time between trainer ticks, and between a server's decode steps.
TRAIN_PERIOD = 1.0
SERVE_PERIOD = 0.25
#: Events a run may pop before it is taken for a runaway schedule.
MAX_EVENTS = 100_000


def _coef(t: int, i: int) -> float:
    """The coefficient trainer ``i`` floods at step ``t``."""
    return 0.01 / (1 + t + i)


class ServeSwarmSim:
    """Trainers flood; servers decode under live updates; churn replays."""

    def __init__(self, cfg, scfg, serve_cfg: ServeConfig, *,
                 n_trainers: int = 2, n_servers: int = 1,
                 train_steps: int = 4, global_seed: int = 0, churn=None,
                 device="cuda"):
        self.cfg = cfg
        self.n_trainers = n_trainers
        self.n = n_trainers + n_servers
        self.train_steps = train_steps
        self.global_seed = global_seed
        self.churn = churn
        self.transport = FloodTransport(graphs.ring(self.n))
        dev = resolve_device(device)
        params = tf.init_params(cfg, 0, dev, serve_cfg.param_dtype)
        self.servers: dict[int, DecodeServer] = {}
        for node in range(n_trainers, self.n):
            bridge = LiveUpdateBridge(cfg, scfg, global_seed, node)
            own = params if node == self.n - 1 else \
                {p: t.clone() for p, t in params.items()}
            self.servers[node] = DecodeServer(cfg, own, serve_cfg,
                                              bridge=bridge, device=dev)
        self.online = {node: True for node in self.servers}
        self._gen = {node: 0 for node in self.servers}
        if churn is not None:
            bad = sorted({n for ev in churn.events for n in ev.nodes
                          if n not in self.servers})
            if bad:
                raise ValueError(f"churn may only target server nodes "
                                 f"{sorted(self.servers)}, got {bad}")

    def submit(self, node: int, req: Request) -> None:
        self.servers[node].submit(req)

    # -- event handlers -------------------------------------------------------

    def _trainer_tick(self, t: int) -> None:
        """One collective train step: every trainer floods its (seed, coef,
        step) message; every online server's bridge buffers its inbox row
        (anti-entropy catch-up from an earlier rejoin rides the same padded
        matrices — FloodTransport prepends its pending payload)."""
        seeds = client_seeds(self.global_seed, t, self.n_trainers)
        msgs = [(i, Message(seed=int(seeds[i]),
                            coef=_coef(t, i), origin=i, step=t))
                for i in range(self.n_trainers)]
        active = np.array([i < self.n_trainers or self.online[i]
                           for i in range(self.n)])
        inbox = self.transport.exchange(msgs, t, active)
        for node, srv in self.servers.items():
            if self.online[node]:
                srv.bridge.ingest(inbox)

    def _server_step(self, ev, q: EventQueue) -> None:
        node = ev.client
        if ev.client_gen != self._gen[node] or not self.online[node]:
            return                      # cancelled by a later churn event
        srv = self.servers[node]
        srv.step()
        if not srv.sched.done:
            q.push(step_event(ev.time + SERVE_PERIOD, node,
                              ev.step + 1, self._gen[node]))

    def _handle_churn(self, ev, q: EventQueue) -> None:
        evs = self.churn.events_at(ev.step)
        for e in evs:
            if e.kind == "leave":
                for node in e.nodes:
                    if self.online[node]:
                        self.servers[node].suspend()
                        self.online[node] = False
                        self._gen[node] += 1
        self.transport.apply_churn(evs)
        for e in evs:
            if e.kind == "join":
                for node in e.nodes:
                    if not self.online[node]:
                        self.online[node] = True
                        self._gen[node] += 1
                        q.push(step_event(ev.time + SERVE_PERIOD, node,
                                          0, self._gen[node]))

    # -- run loop -------------------------------------------------------------

    def run(self) -> dict:
        q = EventQueue()
        for t in range(self.train_steps):
            q.push(step_event(t * TRAIN_PERIOD, TRAINER_TICK, t))
        for node in self.servers:
            q.push(step_event(SERVE_PERIOD, node, 0, self._gen[node]))
        if self.churn is not None:
            for s in sorted({ev.step for ev in self.churn.events}):
                q.push(churn_event(s * TRAIN_PERIOD, s))

        n_events = 0
        while q:
            ev = q.pop()
            n_events += 1
            if n_events > MAX_EVENTS:
                raise RuntimeError(f"serve sim exceeded {MAX_EVENTS} "
                                   f"events — runaway schedule?")
            if ev.rank == RANK_CHURN:
                self._handle_churn(ev, q)
            elif ev.client == TRAINER_TICK:
                self._trainer_tick(ev.step)
            else:
                self._server_step(ev, q)

        stuck = [node for node, srv in self.servers.items()
                 if not srv.sched.done]
        if stuck:
            raise RuntimeError(f"servers {stuck} ended offline with "
                               f"unfinished requests — extend the schedule "
                               f"or rejoin them before the run drains")

        tokens: dict[int, list[int]] = {}
        for node, srv in self.servers.items():
            for rid, toks in srv.results.items():
                if rid in tokens:
                    raise ValueError(f"request id {rid} served by two nodes")
                tokens[rid] = toks
        return {"tokens": tokens,
                "ledger": dataclasses.asdict(self.transport.ledger),
                "servers": {node: srv.stats()
                            for node, srv in self.servers.items()}}
