"""Live-update bridge: flood inbox -> resident serving params (the port of
``repro/serve/bridge.py``).

A serving node holds one full model and subscribes to the same SeedFlood
overlay the trainers flood over.  Each step's
:class:`~repro_torch.core.transport.FloodInbox` row for the node is
buffered here; at the next decode-step boundary the whole buffer folds
into the weights through :func:`repro_torch.core.subcge.apply_messages_epoch`
at a client axis of 1 — the epoch-grouped fold, so messages whose sender
step crosses a τ-refresh boundary are applied under the SENDER's subspace.
That is one ``subcge_apply_epochs`` launch per matrix leaf per fold (and
one dense Gaussian per message for each vector leaf); bf16 weights take
the kernel's bf16 path (``subcge_apply_epochs_bf16``: the delta summed in
float32, W rounded to bf16 once), written in place as float32 ones are.
An update is (seed, coef, step) triples, so no tensors ever ship.

Byte accounting stays in the Transport layer: the bridge only consumes
inbox rows the transport already charged to its CommLedger.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import subcge
from repro_torch.core.messages import pad_pow2
from repro_torch.core.subcge import SubCGEConfig
from repro_torch.models import params as plib
from repro_torch.models import transformer as tf

#: Padding triple for partially filled fold batches: coef 0.0 is an exact
#: no-op on every leaf kind and step -1 matches no epoch slot.
_PAD = (np.uint32(0), np.float32(0.0), np.int32(-1))


class LiveUpdateBridge:
    """Buffers SubCGE flood messages for one serving node and folds them."""

    def __init__(self, arch_cfg, scfg: SubCGEConfig, global_seed: int,
                 node: int):
        self.meta = plib.subcge_meta(tf.arch_spec(arch_cfg))
        self.scfg = scfg
        self.global_seed = global_seed
        self.node = node
        self._seeds: list[int] = []
        self._coefs: list[float] = []
        self._steps: list[int] = []
        self.messages_folded = 0
        self.n_folds = 0

    # -- ingest ---------------------------------------------------------------

    def ingest(self, inbox) -> int:
        """Buffer this node's row of a FloodInbox; returns messages taken."""
        return self.ingest_arrays(inbox.seeds[self.node],
                                  inbox.coefs[self.node],
                                  inbox.steps[self.node])

    def ingest_arrays(self, seeds, coefs, steps) -> int:
        seeds = np.asarray(seeds).reshape(-1)
        coefs = np.asarray(coefs).reshape(-1)
        steps = np.asarray(steps).reshape(-1)
        live = steps >= 0                       # step -1 marks payload padding
        self._seeds.extend(np.uint32(seeds[live]).tolist())
        self._coefs.extend(np.float32(coefs[live]).tolist())
        self._steps.extend(np.int32(steps[live]).tolist())
        return int(live.sum())

    @property
    def pending(self) -> int:
        return len(self._seeds)

    # -- fold -----------------------------------------------------------------

    def fold(self, params: dict) -> dict:
        """Apply every buffered message to ``params`` (one model's flat
        tree, unstacked) in place, pow2-padded as the JAX fold is, and clear
        the buffer.  Returns ``params``."""
        n = self.pending
        if n == 0:
            return params
        K = pad_pow2(n, minimum=1)
        seeds = np.full((1, K), _PAD[0], np.uint32)
        coefs = np.full((1, K), _PAD[1], np.float32)
        steps = np.full((1, K), _PAD[2], np.int32)
        seeds[0, :n] = self._seeds
        coefs[0, :n] = self._coefs
        steps[0, :n] = self._steps
        epochs = subcge.epoch_slots(steps, self.scfg)
        dev = next(iter(params.values())).device
        view = {p: t.unsqueeze(0) for p, t in params.items()}
        subcge.apply_messages_epoch(
            view, self.meta, self.scfg, self.global_seed,
            torch.as_tensor(seeds.astype(np.int64), device=dev),
            torch.as_tensor(coefs, device=dev),
            torch.as_tensor(steps, device=dev), epochs)
        self._seeds.clear()
        self._coefs.clear()
        self._steps.clear()
        self.messages_folded += n
        self.n_folds += 1
        return params

    def stats(self) -> dict:
        return {"messages_folded": self.messages_folded,
                "n_folds": self.n_folds, "pending": self.pending}
