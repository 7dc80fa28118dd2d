"""Gossip with shared randomness (§3.2 strawman) as a Method plugin (the
port of ``repro/dtrain/methods/gossip_sr.py``).

Each client keeps a per-uid coefficient ledger; the transport averages full
histories under the mixing matrix (O(t·n) comm), and ``apply_inbox``
re-applies the coefficient *deltas* message by message, one client at a
time: the O(t·n·d) compute blow-up the paper contrasts against SeedFlood,
counted in ``extra["reconstructions"]``.  Delta replay is epoch-correct: a
reweighted coefficient for message (i, t0) re-applies under the subspace of
ITS origin step t0 (``subcge.apply_messages_epoch`` →
``subcge_apply_epochs``, on a model axis of 1).  The checkpoint keeps the
stacked params as tensors and the ledgers in the metadata, in insertion
order (the JAX package's layout).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import flood, seeds as seedlib, subcge
from repro_torch.core.messages import pad_pow2
from repro_torch.dtrain.api import MethodBase, Outbox, Setup, load_leaves
from repro_torch.models import transformer as tf
from repro_torch.models.perturb import epoch_subspace, sample_pert


@dataclasses.dataclass
class GossipSRState:
    stacked: dict
    hist: list[dict]        # per client: uid -> [seed, alpha_scaled, coef_i]
    applied: list[dict]     # per client: uid -> coef already folded into θ_i
    reconstructions: int = 0


class GossipSRMethod(MethodBase):
    name = "gossip_sr"

    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, setup: Setup) -> GossipSRState:
        self.n = self.cfg.n_clients
        self.meta, self.scfg, self.arch = setup.meta, setup.scfg, setup.arch
        self.device = setup.device
        return GossipSRState(stacked=setup.stacked,
                             hist=[dict() for _ in range(self.n)],
                             applied=[dict() for _ in range(self.n)])

    @torch.no_grad()
    def _estimate_all(self, stacked: dict, tokens, seeds, step: int):
        scfg = self.scfg
        sub = epoch_subspace(self.meta, scfg, self.cfg.seed, step, self.device)
        pert = sample_pert(self.meta, scfg, seeds, scfg.eps)
        lp = tf.lm_loss(self.arch, stacked, tokens, sub=sub, pert=pert)
        lm = tf.lm_loss(self.arch, stacked, tokens, sub=sub,
                        pert=pert.with_scale(-scfg.eps))
        return (lp - lm) / (2 * scfg.eps), 0.5 * (lp + lm)

    @torch.no_grad()
    def _apply_deltas(self, p_i: dict, sds, cfs, sts) -> None:
        """Replay one client's deltas in place, padded to a power of two."""
        K = pad_pow2(len(sds))
        pad_s = np.zeros(K, np.int64)
        pad_s[:len(sds)] = sds
        pad_c = np.zeros(K, np.float32)
        pad_c[:len(cfs)] = cfs
        pad_t = np.full(K, flood.STEP_PAD, np.int32)
        pad_t[:len(sts)] = sts
        dev = self.device
        subcge.apply_messages_epoch(
            p_i, self.meta, self.scfg, self.cfg.seed,
            torch.as_tensor(pad_s[None], device=dev),
            torch.as_tensor(pad_c[None], device=dev),
            torch.as_tensor(pad_t[None], device=dev),
            subcge.epoch_slots(pad_t, self.scfg))

    def local_step(self, state: GossipSRState, tokens: torch.Tensor,
                   active: np.ndarray, t: int):
        cfg, n = self.cfg, self.n
        seeds_np = seedlib.client_seeds(cfg.seed, t, n)
        seeds = torch.as_tensor(seeds_np.astype(np.int64), device=self.device)
        alphas, losses = self._estimate_all(state.stacked, tokens, seeds, t)
        alphas = alphas.cpu().numpy()
        for i in range(n):
            state.hist[i][(i, t)] = [int(seeds_np[i]),
                                     float(-cfg.lr * alphas[i]), 1.0]
        return state, Outbox(losses=losses.cpu().numpy(), payload=state.hist)

    def apply_inbox(self, state: GossipSRState, inbox) -> GossipSRState:
        if inbox is not None:
            state = dataclasses.replace(state, hist=inbox)
        # incremental re-application of coefficient deltas, one client at a
        # time: O(t·n·d), the §3.2 cost blow-up, measured
        reconstructions = state.reconstructions
        for i in range(self.n):
            sds, cfs, sts = [], [], []
            for uid, (sd, a_scaled, c) in state.hist[i].items():
                prev = state.applied[i].get(uid, 0.0)
                delta = c * a_scaled - prev
                if abs(delta) > 0:
                    sds.append(sd)
                    cfs.append(delta)
                    sts.append(uid[1])
                    state.applied[i][uid] = c * a_scaled
            if sds:
                reconstructions += len(sds)
                # a view of client i's rows: the replay writes through
                self._apply_deltas({p: t[i:i + 1]
                                    for p, t in state.stacked.items()},
                                   np.asarray(sds, np.uint32),
                                   np.asarray(cfs, np.float32),
                                   np.asarray(sts, np.int32))
        return dataclasses.replace(state, reconstructions=reconstructions)

    def params_of(self, state: GossipSRState) -> dict:
        return state.stacked

    def result_extra(self, state: GossipSRState) -> dict:
        return {"reconstructions": state.reconstructions}

    # -- checkpointing --------------------------------------------------------
    # uid keys are (origin, step) tuples; JSON flattens each ledger to an
    # insertion-ordered [origin, step, seed, alpha_scaled, coef] list, so
    # the restored dicts iterate (and re-apply deltas) in the same order:
    # float-sum order is part of bitwise reproducibility.

    def state_tree(self, state: GossipSRState) -> dict:
        return {"stacked": state.stacked}

    def state_meta(self, state: GossipSRState) -> dict:
        return {
            "hist": [[[o, t, sd, a, c] for (o, t), (sd, a, c) in h.items()]
                     for h in state.hist],
            "applied": [[[o, t, c] for (o, t), c in a.items()]
                        for a in state.applied],
            "reconstructions": state.reconstructions,
        }

    def load_state(self, state: GossipSRState, tree: dict,
                   meta: dict) -> GossipSRState:
        return GossipSRState(
            stacked=load_leaves(tree["stacked"], state.stacked),
            hist=[{(int(o), int(t)): [int(sd), float(a), float(c)]
                   for o, t, sd, a, c in h} for h in meta["hist"]],
            applied=[{(int(o), int(t)): float(c) for o, t, c in a}
                     for a in meta["applied"]],
            reconstructions=int(meta["reconstructions"]))
