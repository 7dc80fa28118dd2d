"""Zeroth-order MeZO estimators (paper §2.2, §3.1): the port of
``repro/core/zo.py``.

* ``mezo_z`` — the dense Gaussian perturbation a message seed rebuilds (the
  baseline that SubCGE's rank-1 coordinates replace); ``tree_add_scaled`` is
  θ + s·z;
* ``two_point_alpha`` — the symmetric two-point directional derivative
  α = (f(θ+εz) − f(θ−εz)) / 2ε shared by both families (eq. 3/6), and
  ``mezo_alpha`` its dense-Gaussian form;
* ``mezo_apply_messages`` — MeZO's dense-message replay θ ← θ + Σ_k c_k·z_k,
  the O(K·d) stream SubCGE removes (Fig. 5 / Table 4), and ``zo_sgd_step``
  the single-client ZO-SGD step (eq. 4).

All of them work on the port's flat path dicts with a leading client axis:
one seed and one scale per client (or a row of K of them), where JAX would
``vmap``.  A loss function maps such a dict to per-client losses (C,).
"""
from __future__ import annotations

import torch

from repro_torch.core import prng, seeds as seedlib


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


def two_point_alpha(loss_fn, params: dict, z: dict,
                    eps: float) -> torch.Tensor:
    """α = (f(θ+εz) − f(θ−εz)) / 2ε per client: the scalar that travels in
    a message.  ``loss_fn`` takes a stacked dict and returns (C,)."""
    lp = loss_fn(tree_add_scaled(params, z, eps))
    lm = loss_fn(tree_add_scaled(params, z, -eps))
    return (lp - lm) / (2.0 * eps)


def mezo_alpha(loss_fn, params: dict, message_seeds: torch.Tensor,
               eps: float, frozen=None) -> torch.Tensor:
    """``two_point_alpha`` along each client's dense Gaussian ``mezo_z``."""
    return two_point_alpha(loss_fn, params,
                           mezo_z(params, message_seeds, frozen), eps)


def mezo_apply_messages(params: dict, message_seeds: torch.Tensor,
                        coefs: torch.Tensor, frozen=None) -> dict:
    """Replay K dense messages per client, in place: θ ← θ + c_k·N(seed_k).

    ``message_seeds`` and ``coefs`` are (C, K).  The messages are added one
    at a time, k ascending, each scale rounded to the leaf's dtype first:
    the order of JAX's ``lax.scan``, which fixes the bits (the z are never
    summed first).  On a float32 leaf the step is the one XLA CPU compiles
    the scan body to: the scale folded with the normal's sqrt(2) factor,
    then one fused multiply-add onto θ, ``fma(c·√2, erf_inv(u), θ)``
    (emulated in float64: the product is exact); other types add
    ``c·z`` rounded in their type.  A frozen path adds zeros, as JAX's scan
    does.  This O(K·d) memory-bound stream is precisely the cost SubCGE
    removes (Fig. 5); it is the reference and the benchmark baseline.
    """
    for k in range(message_seeds.shape[1]):
        key = seedlib.message_key(message_seeds[:, k])
        for p in seedlib.path_order(params):
            leaf = params[p]
            bshape = (-1,) + (1,) * (leaf.ndim - 1)
            c = coefs[:, k].to(leaf.dtype).reshape(bshape)
            if frozen is not None and frozen(p):
                leaf += c * torch.zeros_like(leaf)
            elif leaf.dtype == torch.float32:
                r = prng.normal_root(seedlib.leaf_key(key, p), leaf.shape[1:])
                s = (c * prng.SQRT2).double()
                leaf.copy_(torch.addcmul(leaf.double(), s, r.double()))
            else:
                z = seedlib.gaussian_like(seedlib.leaf_key(key, p),
                                          leaf.shape[1:]).to(leaf.dtype)
                leaf += c * z
    return params


def zo_sgd_step(loss_fn, params: dict, step_seeds: torch.Tensor, eps: float,
                lr: float):
    """Single-client ZO-SGD (eq. 4), per client: returns (θ − lr·α·z, α)."""
    z = mezo_z(params, step_seeds)
    alpha = two_point_alpha(loss_fn, params, z, eps)
    return tree_add_scaled(params, z, -lr * alpha), alpha
