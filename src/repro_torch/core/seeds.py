"""Shared-randomness primitives (paper §3.1), on :mod:`repro_torch.core.prng`.

The counterpart of ``repro/core/seeds.py``: the same seed layout
(global seed -> step -> client -> leaf), the same blake2s path hash and the
same threefry key derivations, so a seed rebuilds the same perturbation
here as in the JAX package.  Every function accepts a tensor of seeds and
broadcasts over it: one call derives the keys of a whole batch of messages.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.core import prng


def path_hash(path: str) -> int:
    """Stable 31-bit hash of a parameter path (python hash() is salted)."""
    h = hashlib.blake2s(path.encode("utf-8"), digest_size=4).digest()
    return int.from_bytes(h, "little") & 0x7FFFFFFF


def key_from_seed(seed, device=None) -> torch.Tensor:
    """A PRNG key from an integer seed (or a tensor of them): (..., 2)."""
    return prng.PRNGKey(seed, device)


def client_seed(base_seed, step, client) -> np.ndarray:
    """``s_{i,t}``: the seed client ``i`` attaches to its step-``t`` message,
    a uint32 that wraps like jnp (``client`` may be an array of clients).
    Collision-free for (step, client) pairs while clients < 2**16."""
    return (np.asarray(base_seed).astype(np.uint32)
            + np.asarray(step).astype(np.uint32) * np.uint32(65536)
            + np.asarray(client).astype(np.uint32))


def client_seeds(base_seed: int, step: int, n: int) -> np.ndarray:
    """All n clients' ``s_{i,t}`` for one step (uint32, wraps like jnp)."""
    return client_seed(base_seed, step, np.arange(n, dtype=np.uint32))


def message_key(seeds: torch.Tensor) -> torch.Tensor:
    """PRNG keys for seeds that arrived in messages: (..., 2)."""
    return prng.PRNGKey(seeds)


def leaf_key(key: torch.Tensor, path: str) -> torch.Tensor:
    """Per-tensor stream: fold the stable path hash into the key."""
    return prng.fold_in(key, path_hash(path))


def subspace_key(global_seed: int, step: int, path: str,
                 device=None) -> torch.Tensor:
    """Key for (re)generating U_l / V_l at refresh step ``step``.  Steps wrap
    to uint32 (the epoch padding slot -1 folds in 0xFFFFFFFF)."""
    k = prng.fold_in(prng.PRNGKey(global_seed, device), step)
    return leaf_key(k, path)


def coord_sample(key: torch.Tensor, batch_shape, rank: int):
    """Canonical coordinates (i, j) ~ Unif[r]^2 for every layer instance:
    shapes ``key.shape[:-1] + batch_shape`` (int32)."""
    kk = prng.split(key)
    i = prng.randint(kk[..., 0, :], batch_shape, 0, rank)
    j = prng.randint(kk[..., 1, :], batch_shape, 0, rank)
    return i, j


def gaussian_like(key: torch.Tensor, shape) -> torch.Tensor:
    """Dense Gaussian perturbation for non-2D leaves (float32)."""
    return prng.normal(key, shape)


def path_order(paths) -> list[str]:
    """Paths in the order ``jax.tree_util`` flattens a nested dict (sorted
    keys at every level)."""
    return sorted(paths, key=lambda p: tuple(p.split("/")))


def tree_paths(tree: dict) -> list[str]:
    """The '/'-joined leaf paths of a flat path dict, in the order
    ``jax.tree_util`` flattens the nested tree."""
    return path_order(tree)


def map_with_paths(fn, tree: dict) -> dict:
    """``{path: fn(path, leaf)}`` over a flat path dict, visited in
    :func:`tree_paths` order."""
    return {p: fn(p, tree[p]) for p in path_order(tree)}
