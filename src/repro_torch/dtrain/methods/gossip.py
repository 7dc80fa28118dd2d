"""Gossip-averaging baselines as ONE Method composed from strategy parts (the
port of ``repro/dtrain/methods/gossip.py``):

* a *local-update strategy*: :class:`FirstOrderStep` (autograd SGD) or
  :class:`ZeroOrderStep` (MeZO-style two-point estimate);
* an optional :class:`LoRAAdapter` that narrows the trainable dict to
  adapters merged into frozen base weights;
* compression is NOT a method concern: Choco lives entirely in
  ``GossipTransport``.

So ``dsgd`` = FO, ``dzsgd`` = ZO, ``dsgd_lora`` = FO + LoRA, … — six
registry entries over two strategy classes and one adapter.  Every client
steps at once on the stacked client axis (JAX ``vmap``s one client's step).
Under churn, offline clients' trainable leaves are frozen at their
pre-step values (``api.freeze_offline``).  Only the trainable dict is
checkpointed: the base is the seeded init, rebuilt at resume.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import seeds as seedlib, zo
from repro_torch.dtrain import lora as loralib
from repro_torch.dtrain.api import MethodBase, Outbox, Setup, \
    freeze_offline, load_leaves
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class GossipState:
    base: dict         # stacked pretrained weights (frozen under LoRA)
    trainable: dict    # stacked trainable dict (full params or adapters)


class LoRAAdapter:
    """Narrows training and gossip to rank-r q/v adapters (paper §4.2 LoRA
    rows)."""

    def __init__(self, r: int, alpha: float):
        self.r = r
        self.alpha = alpha

    def init_trainable(self, setup: Setup) -> dict:
        lspec = loralib.lora_spec(setup.spec, r=self.r)
        l0 = loralib.lora_init(lspec, setup.cfg.seed + 1, setup.device)
        n = setup.cfg.n_clients
        return {p: t.unsqueeze(0).repeat((n,) + (1,) * t.ndim)
                for p, t in l0.items()}

    def full_params(self, base: dict, lora: dict) -> dict:
        return loralib.merge(base, lora, self.alpha)


def _loss_fn(arch, adapter: LoRAAdapter | None):
    """(base, trainable, tokens) -> per-client losses (C,)."""
    if adapter is None:
        return lambda base, tr, toks: tf.lm_loss(arch, tr, toks)
    return lambda base, tr, toks: tf.lm_loss(
        arch, adapter.full_params(base, tr), toks)


class ZeroOrderStep:
    """MeZO-style two-point local step (DZSGD): one shared-seed Gaussian
    direction per client per step."""

    needs_seeds = True

    def build(self, cfg, arch, adapter: LoRAAdapter | None):
        loss_fn = _loss_fn(arch, adapter)

        @torch.no_grad()
        def local_steps(base, trainable, tokens, seeds):
            z = zo.mezo_z(trainable, seeds)
            lp = loss_fn(base, zo.tree_add_scaled(trainable, z, cfg.eps),
                         tokens)
            lm = loss_fn(base, zo.tree_add_scaled(trainable, z, -cfg.eps),
                         tokens)
            a = (lp - lm) / (2 * cfg.eps)
            return (zo.tree_add_scaled(trainable, z, -cfg.lr * a),
                    0.5 * (lp + lm))
        return local_steps


class FirstOrderStep:
    """Plain autograd SGD local step (DSGD / Choco): the gradient of the sum
    of the per-client losses, whose client c block is client c's own
    gradient (the clients are independent), through the unperturbed
    forward."""

    needs_seeds = False

    def build(self, cfg, arch, adapter: LoRAAdapter | None):
        loss_fn = _loss_fn(arch, adapter)

        def local_steps(base, trainable, tokens):
            tr = {p: t.detach().requires_grad_(True)
                  for p, t in trainable.items()}
            with torch.enable_grad():
                losses = loss_fn(base, tr, tokens)
                grads = list(torch.autograd.grad(losses.sum(),
                                                 list(tr.values())))
            new = {}
            with torch.no_grad():
                # each gradient is dropped once its leaf is stepped, so the
                # step holds one stacked copy of gradients and updates, not
                # two (at the Falcon cut one copy of 4 clients is 15 GB)
                for k, (p, t) in enumerate(tr.items()):
                    new[p] = t.detach() - cfg.lr * grads[k].to(t.dtype)
                    grads[k] = None
            return new, losses.detach()
        return local_steps


class GossipMethod(MethodBase):
    def __init__(self, cfg, name: str, local,
                 adapter: LoRAAdapter | None = None):
        self.cfg = cfg
        self.name = name
        self.local = local
        self.adapter = adapter
        self.churn_aware = cfg.churn is not None

    def init(self, setup: Setup) -> GossipState:
        self.device = setup.device
        trainable = (self.adapter.init_trainable(setup)
                     if self.adapter is not None else setup.stacked)
        self._local_steps = self.local.build(self.cfg, setup.arch,
                                             self.adapter)
        return GossipState(base=setup.stacked, trainable=trainable)

    def initial_payload(self, state: GossipState) -> dict:
        return state.trainable

    def local_step(self, state: GossipState, tokens: torch.Tensor,
                   active: np.ndarray, t: int):
        cfg = self.cfg
        if self.local.needs_seeds:
            seeds = torch.as_tensor(
                seedlib.client_seeds(cfg.seed, t, cfg.n_clients).astype(
                    np.int64), device=self.device)
            new, losses = self._local_steps(state.base, state.trainable,
                                            tokens, seeds)
        else:
            new, losses = self._local_steps(state.base, state.trainable,
                                            tokens)
        # churn: offline clients freeze (no local step); with every client
        # online the freeze is a bitwise no-op and is skipped
        if self.churn_aware or not active.all():
            new = freeze_offline(new, state.trainable, active)
        state = dataclasses.replace(state, trainable=new)
        return state, Outbox(losses=losses.cpu().numpy(), payload=new)

    def apply_inbox(self, state: GossipState, inbox) -> GossipState:
        if inbox is None:
            return state
        return dataclasses.replace(state, trainable=inbox)

    @torch.no_grad()
    def params_of(self, state: GossipState) -> dict:
        if self.adapter is not None:
            return self.adapter.full_params(state.base, state.trainable)
        return state.trainable

    # -- checkpointing --------------------------------------------------------

    def state_tree(self, state: GossipState) -> dict:
        return {"trainable": state.trainable}

    def load_state(self, state: GossipState, tree: dict,
                   meta: dict) -> GossipState:
        return dataclasses.replace(
            state, trainable=load_leaves(tree["trainable"], state.trainable))
