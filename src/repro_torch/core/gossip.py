"""Gossip-based baselines (paper §2.1, §4.2): the port of ``repro/core/gossip.py``.

All baselines operate on *stacked* client parameters — flat dicts of
tensors with a leading client axis ``(n, ...)``:

* ``mix``           — one gossip averaging round θ_i ← Σ_j w_ij θ_j (eq. 2's
                      consensus half), used by DSGD / DZSGD;
* ``choco_*``       — ChocoSGD (Koloskova et al., 2019): gossip on
                      *compressed differences* with per-client surrogate
                      copies x̂ and error feedback, top-k sparsification;
* ``topk_compress`` — the 99 % top-k sparsifier (the paper's Choco setting).

The mixing product and the top-k are library calls (``torch.matmul``,
``torch.topk``): the JAX package computes them with ``Wj @ flat`` and
``jax.lax.top_k``, outside any Pallas kernel.  The ledger entries are
charged by the transport (``core.transport``), never here.
``consensus_error`` lives in ``dtrain.api``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _w32(W: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(W, np.float32), device=device)


def mix(stacked: dict, W: np.ndarray) -> dict:
    """θ ← W θ on the client axis: one synchronous gossip round."""
    Wt = _w32(W, next(iter(stacked.values())).device)
    out = {}
    for p, leaf in stacked.items():
        flat = leaf.reshape(leaf.shape[0], -1).float()
        out[p] = (Wt @ flat).to(leaf.dtype).reshape(leaf.shape)
    return out


# ---------------------------------------------------------------------------
# compression operators
# ---------------------------------------------------------------------------

def topk_compress(x: torch.Tensor, density: float) -> torch.Tensor:
    """Keep the top ⌈density·d⌉ entries by magnitude over the whole tensor
    (a stacked leaf's client axis included), zero the rest.  Every entry
    whose magnitude ties the k-th largest is kept, as in the JAX package.

    Returned dense-with-zeros (the ledger charges only the sparse payload;
    see ``messages.topk_payload_bytes``)."""
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * density))
    mag = flat.abs()
    thresh = torch.topk(mag, k, sorted=False).values.min()
    return (flat * (mag >= thresh)).reshape(x.shape).to(x.dtype)


def tree_topk(tree: dict, density: float) -> dict:
    return {p: topk_compress(leaf, density) for p, leaf in tree.items()}


# ---------------------------------------------------------------------------
# ChocoSGD state
# ---------------------------------------------------------------------------

class ChocoState(NamedTuple):
    x_hat: dict   # stacked surrogate copies x̂_i (n, ...)
    # Neighbour surrogates are recovered as W x̂ since every client can
    # track every neighbour's x̂ from the same compressed stream.


def choco_init(stacked_params: dict) -> ChocoState:
    """Paper App. B.2: surrogates initialized *at the pretrained weights*."""
    return ChocoState(x_hat={p: t.clone() for p, t in stacked_params.items()})


def choco_round(params: dict, state: ChocoState, W: np.ndarray,
                density: float, consensus_lr: float = 1.0,
                active: np.ndarray | None = None):
    """One ChocoSGD communication round; returns (new_params, new_state).

    q_i = C(x_i − x̂_i)            (compress the innovation)
    x̂_i ← x̂_i + q_i               (all clients update all surrogates)
    x_i ← x_i + γ Σ_j w_ij (x̂_j − x̂_i)

    ``active`` (churn): offline clients transmit no innovation, so their
    surrogate copies stay frozen network-wide; ``W``'s identity rows keep
    their parameters untouched.

    Leaf by leaf, so the temporaries stay one leaf large; the surrogates
    are updated in place (they are the transport's own state)."""
    dev = next(iter(params.values())).device
    Wt = _w32(W, dev)
    n = Wt.shape[0]
    L = Wt - torch.eye(n, device=dev)   # Σ_j w_ij (x̂_j − x̂_i) = (W − I) x̂
    mask = None if active is None else torch.as_tensor(
        np.asarray(active, bool), device=dev)
    new_params = {}
    for p, x in params.items():
        xh = state.x_hat[p]
        q = topk_compress(x - xh, density)
        if mask is not None:
            q = torch.where(mask.reshape((-1,) + (1,) * (q.ndim - 1)), q,
                            torch.zeros_like(q))
        xh.add_(q)
        corr = (L @ xh.reshape(n, -1).float()).reshape(xh.shape)
        new_params[p] = (x.float() + consensus_lr * corr).to(x.dtype)
    return new_params, state
