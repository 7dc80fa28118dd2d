"""Optimizers and schedules: the port of ``repro/optim/sgd.py``.

The paper trains with plain constant-LR SGD, no momentum, no weight decay
(App. B.2): for the ZO methods the coefficient η·α/n *is* the SGD step.
Momentum-SGD and Adam are there for first-order ablations; ZO state stays
empty by construction.  Parameters, gradients and state are dicts of
tensors (the port's flat path dicts, or nested dicts of them); every
operation is the JAX package's, in its order and types: a Python scale is
rounded to the tensor's type, Adam's moments are float32.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import Any, Callable, NamedTuple

import torch


def _map(fn, *trees):
    """``jax.tree.map`` over dicts of tensors."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _first(tree) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


class SGDState(NamedTuple):
    momentum: Any | None


def sgd_init(params: dict, momentum: float = 0.0) -> SGDState:
    if momentum == 0.0:
        return SGDState(None)
    return SGDState(_map(torch.zeros_like, params))


def sgd_update(params: dict, grads: dict, state: SGDState, lr: float,
               momentum: float = 0.0):
    """p − lr·g, or with momentum: m ← μ·m + g, p − lr·m."""
    if momentum == 0.0 or state.momentum is None:
        new = _map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
        return new, state
    buf = _map(lambda m, g: momentum * m + g.to(m.dtype), state.momentum,
               grads)
    new = _map(lambda p, m: p - lr * m.to(p.dtype), params, buf)
    return new, SGDState(buf)


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor     # int32, 0-dim


def adam_init(params: dict) -> AdamState:
    z = _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return AdamState(z, _map(torch.clone, z),
                     torch.zeros((), dtype=torch.int32,
                                 device=_first(params).device))


def bias_correction(b: float, count: torch.Tensor) -> torch.Tensor:
    """1 − b^count in float32 (a weak float raised to an int32 count, as
    JAX types it; XLA CPU's float32 ``pow`` of a 0-dim count can differ from
    torch's in the last bit)."""
    return 1 - b ** count


def adam_update(params: dict, grads: dict, state: AdamState, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Adam with bias correction."""
    c = state.count + 1
    mu = _map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
    nu = _map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
              state.nu, grads)
    mh = _map(lambda m: m / bias_correction(b1, c), mu)
    vh = _map(lambda v: v / bias_correction(b2, c), nu)
    new = _map(lambda p, m, v: (p - lr * m / (torch.sqrt(v) + eps)).to(
        p.dtype), params, mh, vh)
    return new, AdamState(mu, nu, c)


def constant_lr(lr: float) -> Callable[[int], float]:
    return lambda step: lr


@functools.cache
def _cosf():
    """The C library's float32 ``cosf``: what XLA CPU lowers ``jnp.cos`` of
    a float32 to (float64 ``math.cos`` rounded to float32 differs from it
    in ~1 % of cosine_lr's arguments)."""
    cosf = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    cosf.restype = ctypes.c_float
    cosf.argtypes = [ctypes.c_float]
    return cosf


def cosine_lr(lr: float, total: int, warmup: int = 0) -> Callable[[int], float]:
    """Linear warmup, then half a cosine from lr to 0 over the rest; the
    cosine in float32 (JAX's ``jnp.cos`` of a weak float)."""
    def fn(step: int) -> float:
        if warmup and step < warmup:
            return lr * (step + 1) / warmup
        t = (step - warmup) / max(1, total - warmup)
        return 0.5 * lr * (1.0 + _cosf()(math.pi * min(t, 1.0)))
    return fn
