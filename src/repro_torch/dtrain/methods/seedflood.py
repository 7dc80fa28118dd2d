"""SeedFlood (Algorithm 1), the batched path of ``repro/dtrain/methods/seedflood.py``.

One step over the stacked client axis:

* ``estimate_and_update`` — every client's ±ε dual forward through the
  fused rank-1 kernels, its coefficient ``-η·α/n``, and its own rank-r
  update (``subcge.apply_messages`` → ``subcge_apply``), in place;
* the outbox — one seed–scalar ``Message`` per client;
* ``apply_inbox`` → ``replay_batched`` — every received message replayed
  under its SENDER's τ-epoch (``subcge.apply_messages_epoch`` →
  ``subcge_apply_epochs``), in place.

``seedflood.*`` profiler ranges (``torch.profiler.record_function``; a few
microseconds each when no profiler runs) mark the phases of a step:
sample, dual_forward, own_update, replay.  ``chip_smoke.py --profile``
reads them.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import seeds as seedlib, subcge
from repro_torch.core.messages import Message
from repro_torch.core.transport import FloodInbox
from repro_torch.dtrain.api import MethodBase, Outbox, Setup
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
    def estimate_and_update(self, stacked: dict, tokens: torch.Tensor,
                            seeds: torch.Tensor, step: int):
        """(A)+(B): ZO estimates, coefficients and each client's own update.
        ``stacked`` is updated in place (the JAX step donates it)."""
        cfg, scfg = self.cfg, self.scfg
        with record_function("seedflood.sample"):
            sub = epoch_subspace(self.meta, scfg, cfg.seed, step, self.device)
            pert = sample_pert(self.meta, scfg, seeds, scfg.eps)
        with record_function("seedflood.dual_forward"):
            lp = tf.lm_loss(self.arch, stacked, tokens, sub=sub, pert=pert)
            lm = tf.lm_loss(self.arch, stacked, tokens, sub=sub,
                            pert=pert.with_scale(-scfg.eps))
        alphas = (lp - lm) / (2 * scfg.eps)
        losses = 0.5 * (lp + lm)
        coefs = -cfg.lr * alphas / float(self.n)
        with record_function("seedflood.own_update"):
            subcge.apply_messages(stacked, self.meta, scfg, sub,
                                  seeds[:, None], coefs[:, None])
        return stacked, losses, coefs

    def local_step(self, stacked: dict, tokens: torch.Tensor, t: int):
        seeds_np = seedlib.client_seeds(self.cfg.seed, t, self.n)
        seeds = torch.as_tensor(seeds_np.astype(np.int64), device=self.device)
        stacked, losses, coefs_t = self.estimate_and_update(stacked, tokens,
                                                            seeds, t)
        coefs = coefs_t.cpu().numpy()
        outbox = [(i, Message(seed=int(seeds_np[i]), coef=float(coefs[i]),
                              origin=i, step=t)) for i in range(self.n)]
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

    def apply_inbox(self, stacked: dict, inbox: FloodInbox | None) -> dict:
        if inbox is None or inbox.seeds.shape[1] == 0:
            return stacked
        epochs = subcge.epoch_slots(inbox.steps, self.scfg)
        return self.replay_batched(stacked, inbox.seeds, inbox.coefs,
                                   inbox.steps, epochs)

    def label(self, transport_stats: dict) -> str:
        k = (self.cfg.flood_k if self.cfg.flood_k is not None
             else transport_stats.get("diameter"))
        return f"seedflood(k={k})"
