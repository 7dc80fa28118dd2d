"""SeedFlood (Algorithm 1): the port of ``repro/dtrain/methods/seedflood.py``.

One step over the stacked client axis (``batched_step=True``, the default):

* ``estimate_and_update`` — every client's ±ε dual forward through the
  fused rank-1 kernels, its coefficient ``-η·α/n_eff`` (n_eff the sum of
  ``active``, at least 1: the online clients, or under the event engine
  the float cohort weights that sum to them), and each client's own
  rank-r update where its weight is nonzero
  (``subcge.apply_messages`` → ``subcge_apply``), in place.  An offline
  client applies a coefficient of 0, an exact no-op: this method's offline
  freeze;
* the outbox — one seed–scalar ``Message`` per online client;
* ``apply_inbox`` → ``replay_batched`` — every received message replayed
  under its SENDER's τ-epoch (``subcge.apply_messages_epoch`` →
  ``subcge_apply_epochs``), in place.  ``epoch_replay=False`` pins live
  messages to the receiver's step instead: the JAX package's regression
  arm, wrong whenever staleness crosses a τ boundary.

The per-client reference path (``batched_step=False``) keeps the batched
dual forward (``estimate_all``) and then, client by client on its view of
the stacked params, applies the own update (``update_one``: a client axis
of 1, online clients only) and the replay (``replay_one``: clients with a
live message only), with the JAX arm's host-side coefficient arithmetic
(``n_eff`` an ``int``).  A view updated in place gives the bits of JAX's
unstack / restack without a second copy of the stacked leaves.

The state is the stacked params; it checkpoints as ``{"stacked": ...}``,
the JAX package's layout.

``seedflood.*`` profiler ranges (``torch.profiler.record_function``; a few
microseconds each when no profiler runs) mark the phases of a step on both
paths: sample, dual_forward, own_update, replay.  ``chip_smoke.py
--profile`` reads them.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import flood, seeds as seedlib, subcge
from repro_torch.core.messages import Message
from repro_torch.core.transport import FloodInbox
from repro_torch.dtrain.api import MethodBase, Outbox, Setup, load_leaves
from repro_torch.models import transformer as tf
from repro_torch.models.perturb import epoch_subspace, sample_pert


class SeedFloodMethod(MethodBase):
    name = "seedflood"

    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, setup: Setup) -> dict:
        self.n = self.cfg.n_clients
        self.meta, self.scfg, self.arch = setup.meta, setup.scfg, setup.arch
        self.device = setup.device
        return setup.stacked

    @torch.no_grad()
    def estimate_all(self, stacked: dict, tokens: torch.Tensor,
                     seeds: torch.Tensor, step: int):
        """(A): every client's ZO estimate α and loss, over the stacked
        client axis; also returns the step's subspace."""
        scfg = self.scfg
        with record_function("seedflood.sample"):
            sub = epoch_subspace(self.meta, scfg, self.cfg.seed, step,
                                 self.device)
            pert = sample_pert(self.meta, scfg, seeds, scfg.eps)
        with record_function("seedflood.dual_forward"):
            lp = tf.lm_loss(self.arch, stacked, tokens, sub=sub, pert=pert)
            lm = tf.lm_loss(self.arch, stacked, tokens, sub=sub,
                            pert=pert.with_scale(-scfg.eps))
        return (lp - lm) / (2 * scfg.eps), 0.5 * (lp + lm), sub

    @torch.no_grad()
    def estimate_and_update(self, stacked: dict, tokens: torch.Tensor,
                            seeds: torch.Tensor, step: int,
                            active: np.ndarray):
        """(A)+(B): ZO estimates, coefficients and each online client's own
        update.  ``stacked`` is updated in place (the JAX step donates it)."""
        alphas, losses, sub = self.estimate_all(stacked, tokens, seeds, step)
        # ``active`` is a boolean mask (the Trainer) or float cohort weights
        # (the EventTrainer: integer-valued, so the sum is exact)
        n_eff = float(max(float(np.sum(active)), 1.0))
        coefs = -self.cfg.lr * alphas / n_eff
        on = torch.as_tensor(np.asarray(active) > 0, device=coefs.device)
        own = torch.where(on, coefs, torch.zeros_like(coefs))
        with record_function("seedflood.own_update"):
            subcge.apply_messages(stacked, self.meta, self.scfg, sub,
                                  seeds[:, None], own[:, None])
        return stacked, losses, coefs

    def _client(self, stacked: dict, i: int) -> dict:
        """Client i's view of the stacked params (a client axis of 1):
        updating it in place updates ``stacked``."""
        return {p: t[i:i + 1] for p, t in stacked.items()}

    @torch.no_grad()
    def update_one(self, stacked: dict, i: int, seeds: torch.Tensor,
                   coefs: torch.Tensor, sub: dict) -> None:
        """(B) on the per-client path: client i applies its own message(s),
        (1, K) seeds and coefficients, in place."""
        with record_function("seedflood.own_update"):
            subcge.apply_messages(self._client(stacked, i), self.meta,
                                  self.scfg, sub, seeds, coefs)

    def local_step(self, stacked: dict, tokens: torch.Tensor,
                   active: np.ndarray, t: int):
        cfg = self.cfg
        seeds_np = seedlib.client_seeds(cfg.seed, t, self.n)
        seeds = torch.as_tensor(seeds_np.astype(np.int64), device=self.device)
        if cfg.batched_step:
            stacked, losses, coefs_t = self.estimate_and_update(
                stacked, tokens, seeds, t, active)
            coefs = coefs_t.cpu().numpy()
        else:
            alphas, losses, sub = self.estimate_all(stacked, tokens, seeds, t)
            n_eff = max(int(active.sum()), 1)   # == n on a static topology
            # float32 like the batched path (numpy would silently promote)
            coefs = (-cfg.lr * alphas.cpu().numpy() / n_eff).astype(
                np.float32)
            # (B) each online client applies its own message at once;
            # offline clients freeze (no step, no message)
            cf = torch.as_tensor(coefs, device=self.device)
            for i in range(self.n):
                if active[i]:
                    self.update_one(stacked, i, seeds[i:i + 1, None],
                                    cf[i:i + 1, None], sub)
        # (C) online clients inject their fresh messages into the flood
        outbox = [(i, Message(seed=int(seeds_np[i]), coef=float(coefs[i]),
                              origin=i, step=t))
                  for i in range(self.n) if active[i] > 0]
        return stacked, Outbox(losses=losses.cpu().numpy(), payload=outbox)

    @torch.no_grad()
    def replay_batched(self, stacked: dict, seeds, coefs, steps, epochs):
        """(C): one batched, epoch-correct replay of the (n, K) payloads."""
        dev = self.device
        with record_function("seedflood.replay"):
            return subcge.apply_messages_epoch(
                stacked, self.meta, self.scfg, self.cfg.seed,
                torch.as_tensor(seeds.astype(np.int64), device=dev),
                torch.as_tensor(coefs, device=dev),
                torch.as_tensor(steps, device=dev), epochs)

    @torch.no_grad()
    def replay_one(self, stacked: dict, i: int, seeds, coefs, steps,
                   epochs) -> None:
        """(C) on the per-client path: client i's (K,) payload row replayed
        under the senders' epochs, in place on its view."""
        dev = self.device
        with record_function("seedflood.replay"):
            subcge.apply_messages_epoch(
                self._client(stacked, i), self.meta, self.scfg,
                self.cfg.seed,
                torch.as_tensor(seeds[None].astype(np.int64), device=dev),
                torch.as_tensor(coefs[None], device=dev),
                torch.as_tensor(steps[None], device=dev), epochs)

    def apply_inbox(self, stacked: dict, inbox: FloodInbox | None) -> dict:
        if inbox is None or inbox.seeds.shape[1] == 0:
            return stacked
        steps = inbox.steps
        if not self.cfg.epoch_replay:
            # the regression arm: pin every live message to the receiver's
            # epoch (the JAX package's pre-fix replay)
            steps = np.where(inbox.coefs != 0.0, np.int32(inbox.t),
                             np.int32(flood.STEP_PAD))
        epochs = subcge.epoch_slots(steps, self.scfg)  # sfcheck: noqa[SF010] -- epoch_replay=False above is the receiver-step regression arm, kept as in the JAX package; the default path passes inbox.steps untouched and tests/test_torch_churn.py pins the divergence across a τ boundary
        if self.cfg.batched_step:
            return self.replay_batched(stacked, inbox.seeds, inbox.coefs,
                                       steps, epochs)
        for i in range(self.n):
            if (inbox.coefs[i] != 0.0).any():
                self.replay_one(stacked, i, inbox.seeds[i], inbox.coefs[i],
                                steps[i], epochs)
        return stacked

    def label(self, transport_stats: dict) -> str:
        k = (self.cfg.flood_k if self.cfg.flood_k is not None
             else transport_stats.get("diameter"))
        return f"seedflood(k={k})"

    # -- checkpointing --------------------------------------------------------

    def state_tree(self, stacked: dict) -> dict:
        return {"stacked": stacked}

    def load_state(self, stacked: dict, tree: dict, meta: dict) -> dict:
        return load_leaves(tree["stacked"], stacked)
