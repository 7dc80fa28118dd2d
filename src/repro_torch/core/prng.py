"""Bit-exact ``jax.random`` (threefry2x32, partitionable mode) in torch.

SeedFlood's wire format is ``(seed, coef, step)``: every perturbation, every
SubCGE subspace and every initial weight is regenerated from an integer seed
through JAX's threefry2x32 counter-based generator.  A torch client can only
replay a JAX client's messages (and be held against the JAX reference at
all) if it regenerates the very same bits, so this module re-implements the
generator instead of using ``torch.Generator``.

Representation: a key is an int64 tensor of shape ``(..., 2)`` whose entries
are uint32 values; all 32-bit unsigned arithmetic is emulated in int64 with
``& 0xFFFFFFFF`` masks.  Everything works on any device and broadcasts over
leading key dimensions, so one call samples for a whole batch of seeds.

Semantics follow ``jax/_src/prng.py`` and ``jax/_src/random.py`` with
``jax_threefry_partitionable=True`` (the default since jax 0.5):

* ``PRNGKey(s)     = [0, s mod 2^32]``  (a 32-bit seed: negative seeds wrap)
* ``fold_in(k, d)  = threefry(k, (0, d))``
* ``split(k, n)[i] = threefry(k, (0, i))``  (hi/lo words of a 64-bit iota)
* ``random_bits``  = ``b1 ^ b2`` of ``threefry(k, iota_2x32(shape))``
* ``randint``      = two bit draws from ``split(k)``, combined as in
  ``random._randint`` (not ``bits % span``)
* ``normal``       = ``sqrt(2) * erf_inv(uniform(nextafter(-1, 0), 1))`` with
  XLA's float32 ``ErfInv`` polynomial (Giles), not ``torch.erfinv``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# random_bits works on at most this many counters at once (bounds the int64
# temporaries of a 155M-element embedding draw to a few hundred MB)
_CHUNK = 1 << 24


def _u32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return torch.as_tensor(np.asarray(x, dtype=np.int64) & M32,
                           dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & M32) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 block cipher (20 rounds), elementwise with
    broadcasting; all arguments are uint32 values held in int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & M32
    return x1, x2


def PRNGKey(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey`` for 32-bit seeds (scalar or tensor of seeds)."""
    s = _u32(seed, device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    d = _u32(data, key.device)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(..., 2) -> (..., num, 2)."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit random words, shape ``key.shape[:-1] + shape`` (int64)."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    k1, k2 = key[..., 0, None], key[..., 1, None]
    parts = []
    for start in range(0, max(n, 1), _CHUNK):
        idx = torch.arange(start, min(n, start + _CHUNK), dtype=torch.int64,
                           device=key.device)
        b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & M32)
        parts.append(b1 ^ b2)
    bits = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    return bits.reshape(key.shape[:-1] + shape)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 in [0, 1): mantissa fill of 1.0, minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: torch.Tensor, shape, minval=0.0, maxval=1.0) -> torch.Tensor:
    dev = key.device
    lo = torch.tensor(minval, dtype=torch.float32, device=dev)
    hi = torch.tensor(maxval, dtype=torch.float32, device=dev)
    u = _bits_to_unit(random_bits(key, shape))
    return torch.maximum(lo, u * (hi - lo) + lo)


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for uint32 operands, without int64 overflow."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``."""
    kk = split(key)
    hi_bits = random_bits(kk[..., 0, :], shape)
    lo_bits = random_bits(kk[..., 1, :], shape)
    span = (maxval - minval) & M32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span      # uint32 product wraps, as in XLA
    off = (_mul32(hi_bits % span, torch.full_like(hi_bits, mult))
           + lo_bits % span) & M32
    off = off % span
    return (minval + off).to(torch.int32)


# XLA's float32 ErfInv (Giles' single-precision approximation); the
# coefficients are XLA's, in Horner order from the highest power.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function with XLA's rounding sequence (every
    multiply and add rounded separately, as the HLO spells it)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], dtype=x.dtype,
                                            device=x.device),
                           torch.tensor(_ERFINV_GE5[i], dtype=x.dtype,
                                        device=x.device))

    p = coef(0)
    for i in range(1, 9):
        p = coef(i) + p * w
    res = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, res)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return erf_inv(u) * _SQRT2
