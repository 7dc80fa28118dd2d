"""Zeroth-order MeZO estimators (paper §2.2): the port of the parts of
``repro/core/zo.py`` the gossip baselines run.

``mezo_z`` is the dense Gaussian perturbation a message seed rebuilds (the
baseline that SubCGE's rank-1 coordinates replace); ``tree_add_scaled`` is
θ + s·z.  Both work on the port's flat path dicts with a leading client
axis: one seed and one scale per client, where JAX would ``vmap``.
"""
from __future__ import annotations

import torch

from repro_torch.core import seeds as seedlib


def tree_add_scaled(params: dict, z: dict, scale) -> dict:
    """θ + s·z per leaf; ``scale`` is a float or a per-client (C,) tensor,
    rounded to the leaf's dtype first (``jnp.asarray(scale, p.dtype)``)."""
    out = {}
    for p, leaf in params.items():
        s = torch.as_tensor(scale, dtype=leaf.dtype, device=leaf.device)
        if s.ndim:
            s = s.reshape((-1,) + (1,) * (leaf.ndim - 1))
        out[p] = leaf + s * z[p].to(leaf.dtype)
    return out


def mezo_z(params: dict, message_seeds: torch.Tensor,
           frozen=None) -> dict:
    """Dense Gaussian perturbation rebuilt from each client's message seed:
    ``message_seeds`` (C,) uint32 values (int64); leaves (C, *shape).  A
    path for which ``frozen(path)`` holds gets zeros."""
    key = seedlib.message_key(message_seeds)
    out = {}
    for p in seedlib.path_order(params):
        leaf = params[p]
        if frozen is not None and frozen(p):
            out[p] = torch.zeros_like(leaf)
        else:
            out[p] = seedlib.gaussian_like(seedlib.leaf_key(key, p),
                                           leaf.shape[1:]).to(leaf.dtype)
    return out
