"""The ONE training loop every method runs through (the port of
``repro/dtrain/trainer.py``):

    bind(initial payload) -> [churn events -> active mask -> local step
    -> log loss -> transport exchange -> apply inbox -> eval / checkpoint
    cadence] ... -> drain -> RunResult

Churn events land at the start of their step; a rejoined client's
anti-entropy catch-up rides in that step's exchange.  Checkpoints
(``checkpoint_every`` / ``resume_from``) hold method state, transport state
(flood frontiers, message tables, seen-sets and the ledger) and the logged
curves, in the JAX package's layout (``repro_torch.checkpoint.ckpt``).
Every random draw is counter-based in (seed, step), so restoring state and
the step counter restores the trajectory: a resumed run ends bitwise equal
to the uninterrupted one.

The RunResult reports the averaged model's test accuracy ``gmp`` and, in
``extra``, its ``valid_loss``, the stacked params ``final_stacked`` (from
the method's ``params_of``), the transport's stats and the method's own
``result_extra``.  Per-step wall time ends in ``torch.cuda.synchronize()``
(the JAX loop's ``block_until_ready``), so it measures the device's work,
not the enqueue.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.dtrain.api import RunResult, Setup, active_consensus, \
    log_step_loss
from repro_torch.topology.dynamic import ChurnSchedule


class Trainer:
    """Drives one decentralized run of ``method`` over ``transport``."""

    def __init__(self, cfg, setup: Setup, method, transport,
                 churn: ChurnSchedule | None = None):
        self.cfg = cfg
        self.setup = setup
        self.method = method
        self.transport = transport
        self.churn = churn

    def _sync(self) -> None:
        if self.setup.device.type == "cuda":
            torch.cuda.synchronize(self.setup.device)

    # -- checkpoint plumbing ---------------------------------------------------

    def _ckpt_path(self, step: int) -> str:
        return os.path.join(self.cfg.checkpoint_dir, f"step{step:06d}.npz")

    def _save_checkpoint(self, step: int, state, curves) -> None:
        loss_curve, acc_curve, consensus_curve, step_wall_s = curves
        tree = {"method": self.method.state_tree(state)}
        tarrs = self.transport.state_arrays()
        if tarrs is not None:
            tree["transport"] = tarrs
        ckpt.save(self._ckpt_path(step), tree, metadata={
            "step": step,
            "method": self.cfg.method,
            "loss_curve": loss_curve,
            "acc_curve": acc_curve,
            "consensus_curve": consensus_curve,
            "step_wall_s": step_wall_s,
            "method_meta": self.method.state_meta(state),
            "transport_meta": self.transport.state_meta(),
        })

    def _resume(self, state, curves):
        tree, meta = ckpt.load(self.cfg.resume_from)
        if meta.get("method") != self.cfg.method:
            raise ValueError(
                f"checkpoint was written by method '{meta.get('method')}', "
                f"cannot resume a '{self.cfg.method}' run from it")
        state = self.method.load_state(state, tree["method"],
                                       meta.get("method_meta") or {})
        self.transport.load_state(tree.get("transport"),
                                  meta.get("transport_meta") or {})
        loss_curve, acc_curve, consensus_curve, step_wall_s = curves
        loss_curve += [float(x) for x in meta["loss_curve"]]
        acc_curve += [(int(s), float(a)) for s, a in meta["acc_curve"]]
        consensus_curve += [(int(s), float(c))
                            for s, c in meta["consensus_curve"]]
        step_wall_s += [float(x) for x in meta["step_wall_s"]]
        return state, int(meta["step"])

    # -- the loop --------------------------------------------------------------

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
        curves = (loss_curve, acc_curve, consensus_curve, step_wall_s)
        start = 0
        if cfg.resume_from:
            state, start = self._resume(state, curves)
        t0 = time.time()                # reporting only; no RNG reads clocks

        for t in range(start, cfg.steps):
            t_step = time.perf_counter()
            if self.churn is not None:
                events = self.churn.events_at(t)
                if events:
                    transport.apply_churn(events)
            active = transport.active_mask()
            state, outbox = method.local_step(state, s.batches(t), active, t)
            log_step_loss(loss_curve, np.asarray(outbox.losses),
                          active[:len(outbox.losses)])
            inbox = transport.exchange(outbox.payload, t, active)
            # the payload may be a whole stacked model (gossip): free it
            # before the next step rather than hold it through that step
            del outbox
            state = method.apply_inbox(state, inbox)
            self._sync()
            dt = time.perf_counter() - t_step
            if t == start:
                compile_wall_s = dt
            else:
                step_wall_s.append(dt)
            if cfg.eval_every and (t + 1) % cfg.eval_every == 0:
                stacked = method.params_of(state)
                acc_curve.append((t + 1, s.gmp(stacked)))
                consensus_curve.append((t + 1,
                                        active_consensus(stacked, active)))
            if cfg.checkpoint_every and (t + 1) % cfg.checkpoint_every == 0:
                self._save_checkpoint(t + 1, state, curves)

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
