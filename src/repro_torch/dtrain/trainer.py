"""The ONE training loop every method runs through (``repro/dtrain/trainer.py``
without churn or checkpoints):

    bind(initial payload) -> [local step -> log loss -> transport exchange
    -> apply inbox -> eval cadence] ... -> drain -> RunResult

The RunResult reports the averaged model's test accuracy ``gmp`` and, in
``extra``, its ``valid_loss``, the stacked params ``final_stacked`` (from
the method's ``params_of``), the transport's stats and the method's own
``result_extra``.  Per-step wall time ends in ``torch.cuda.synchronize()``
(the JAX loop's ``block_until_ready``), so it measures the device's work,
not the enqueue.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.dtrain.api import RunResult, Setup, active_consensus, \
    log_step_loss


class Trainer:
    """Drives one decentralized run of ``method`` over ``transport``."""

    def __init__(self, cfg, setup: Setup, method, transport):
        self.cfg = cfg
        self.setup = setup
        self.method = method
        self.transport = transport

    def _sync(self) -> None:
        if self.setup.device.type == "cuda":
            torch.cuda.synchronize(self.setup.device)

    def run(self) -> RunResult:
        cfg, s, method, transport = (self.cfg, self.setup, self.method,
                                     self.transport)
        state = method.init(s)
        transport.bind(method.initial_payload(state))
        loss_curve: list[float] = []
        acc_curve: list[tuple[int, float]] = []
        consensus_curve: list[tuple[int, float]] = []
        step_wall_s: list[float] = []   # steady-state samples only
        compile_wall_s = 0.0            # the first step (builds, warm-up)
        t0 = time.time()                # reporting only; no RNG reads clocks

        for t in range(cfg.steps):
            t_step = time.perf_counter()
            active = transport.active_mask()
            state, outbox = method.local_step(state, s.batches(t), t)
            log_step_loss(loss_curve, np.asarray(outbox.losses),
                          active[:len(outbox.losses)])
            inbox = transport.exchange(outbox.payload, t, active)
            # the payload may be a whole stacked model (gossip): free it
            # before the next step rather than hold it through that step
            del outbox
            state = method.apply_inbox(state, inbox)
            self._sync()
            dt = time.perf_counter() - t_step
            if t == 0:
                compile_wall_s = dt
            else:
                step_wall_s.append(dt)
            if cfg.eval_every and (t + 1) % cfg.eval_every == 0:
                stacked = method.params_of(state)
                acc_curve.append((t + 1, s.gmp(stacked)))
                consensus_curve.append((t + 1,
                                        active_consensus(stacked, active)))

        if cfg.drain:
            for inbox in transport.drain(cfg.steps + 1, cfg.steps):
                state = method.apply_inbox(state, inbox)
            self._sync()

        active = transport.active_mask()
        stacked = method.params_of(state)
        stats = transport.stats()
        extra = {"n_params": s.n_params, **stats,
                 "valid_loss": s.valid_loss(stacked),
                 "consensus_curve": consensus_curve,
                 "step_wall_s": step_wall_s, "final_stacked": stacked,
                 **method.result_extra(state)}
        return RunResult(
            method=method.label(stats), gmp=s.gmp(stacked),
            loss_curve=loss_curve, acc_curve=acc_curve,
            bytes_per_edge=transport.ledger.per_edge,
            total_bytes=transport.ledger.total_bytes,
            consensus_error=active_consensus(stacked, active),
            wall_s=time.time() - t0, compile_wall_s=compile_wall_s,
            extra=extra)
