"""Centralized SubCGE-ZO oracle as a Method plugin (the port of
``repro/dtrain/methods/central_zo.py``).

n perturbations of ONE shared model per step, averaging the n two-point
estimates: mathematically SeedFlood under full flooding (same seeds, same
batches).  Composes with ``NullTransport`` (no communication, zero bytes).
Also hosts the beyond-paper subspace momentum (a velocity in the r×r
coefficient space, reset at every τ-refresh).

The shared model is kept stacked on a model axis of 1.  The dual forward
views it as n clients through ``expand`` (a client stride of 0: the
rank-1 kernels read the one copy n times, and no copy is made); the
update applies the n messages to the one model (``subcge_apply`` at a
model axis of 1).  The checkpoint holds the one model and the velocity
without that axis, the JAX package's layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import seeds as seedlib, subcge
from repro_torch.dtrain.api import MethodBase, Outbox, Setup, load_leaves
from repro_torch.models import transformer as tf
from repro_torch.models.perturb import epoch_subspace, sample_pert


@dataclasses.dataclass
class CentralZOState:
    params: dict        # path -> (1, ...)
    velocity: dict      # path -> (1, *B, r, r); empty without momentum


class CentralZOMethod(MethodBase):
    name = "central_zo"

    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, setup: Setup) -> CentralZOState:
        self.n = self.cfg.n_clients
        self.meta, self.scfg, self.arch = setup.meta, setup.scfg, setup.arch
        self.device = setup.device
        params = {p: t[:1].clone() for p, t in setup.stacked.items()}
        velocity = (subcge.zero_buffers(self.meta, self.scfg, 1, self.device)
                    if self.cfg.momentum > 0.0 else {})
        return CentralZOState(params=params, velocity=velocity)

    @torch.no_grad()
    def local_step(self, state: CentralZOState, tokens: torch.Tensor,
                   active: np.ndarray, t: int):
        cfg, scfg, n = self.cfg, self.scfg, self.n
        seeds = torch.as_tensor(
            seedlib.client_seeds(cfg.seed, t, n).astype(np.int64),
            device=self.device)
        sub = epoch_subspace(self.meta, scfg, cfg.seed, t, self.device)
        pert = sample_pert(self.meta, scfg, seeds, scfg.eps)
        view = {p: w.expand((n,) + w.shape[1:])
                for p, w in state.params.items()}
        lp = tf.lm_loss(self.arch, view, tokens, sub=sub, pert=pert)
        lm = tf.lm_loss(self.arch, view, tokens, sub=sub,
                        pert=pert.with_scale(-scfg.eps))
        del view
        alphas = (lp - lm) / (2 * scfg.eps)
        coefs = (-cfg.lr * alphas / float(n))[None]
        velocity = state.velocity
        if cfg.momentum > 0.0:
            if t > 0 and t % scfg.refresh_period == 0:
                velocity = {p: torch.zeros_like(v) for p, v in velocity.items()}
            params, velocity = subcge.momentum_apply(
                state.params, self.meta, scfg, sub, velocity, seeds[None],
                coefs, beta=cfg.momentum)
        else:
            params = subcge.apply_messages(state.params, self.meta, scfg, sub,
                                           seeds[None], coefs)
        loss = torch.mean(0.5 * (lp + lm))
        return (CentralZOState(params=params, velocity=velocity),
                Outbox(losses=loss.cpu().numpy().reshape(1)))

    def apply_inbox(self, state: CentralZOState, inbox) -> CentralZOState:
        return state

    def params_of(self, state: CentralZOState) -> dict:
        return state.params

    def result_extra(self, state: CentralZOState) -> dict:
        return {"final_params": {p: t[0] for p, t in state.params.items()}}

    # -- checkpointing --------------------------------------------------------

    def state_tree(self, state: CentralZOState) -> dict:
        return {"params": {p: t[0] for p, t in state.params.items()},
                "velocity": {p: v[0] for p, v in state.velocity.items()}}

    def load_state(self, state: CentralZOState, tree: dict,
                   meta: dict) -> CentralZOState:
        velocity = (load_leaves(tree["velocity"], state.velocity)
                    if state.velocity else {})
        return CentralZOState(params=load_leaves(tree["params"], state.params),
                              velocity=velocity)
