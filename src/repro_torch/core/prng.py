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
  XLA's float32 ``ErfInv`` polynomial (Giles), not ``torch.erfinv``, over
  XLA CPU's float32 ``log1p`` (:func:`log1p_xla`), not ``torch.log1p``.
* bf16 draws (``uniform``, ``gumbel``, ``categorical`` on bf16 logits)
  take 8-bit words, as ``random._uniform`` does for a type of fewer than 8
  mantissa bits: the low byte of the 32-bit word at the same counter.
  Every bf16 operation is one float32 operation rounded to bf16, as XLA
  CPU computes bf16 (so ``gumbel`` rounds between its two logs).

The reference is JAX on the CPU: XLA on a GPU or TPU lowers ``log1p`` with
other polynomials and rounds differently again.  The same code runs on any
torch device and gives the same bits there (float64 emulates each fused
multiply-add exactly; every other step is one correctly rounded float32
operation).
"""
from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# random_bits, uniform and normal work on at most this many elements at once
# (bounds the temporaries of a 470M-element expert-weight draw to a few
# hundred MB)
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


def _bits_range(key: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """The words of flat counters ``start .. stop - 1``: (..., stop - start).
    Under ``jax_threefry_partitionable`` a word depends on its own counter
    only, so any split of the counter range gives the same bits."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], idx >> 32,
                          idx & M32)
    return b1 ^ b2


def _map_bits(key: torch.Tensor, shape, fn, dtype) -> torch.Tensor:
    """``fn(words)`` over the flat counter range of ``shape``, a chunk of at
    most :data:`_CHUNK` elements (all keys together) at a time, written into
    one output of shape ``key.shape[:-1] + shape``: the int64 and float64
    temporaries stay a few hundred MB for a draw of any size."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    batch = tuple(key.shape[:-1])
    out = torch.empty(batch + (n,), dtype=dtype, device=key.device)
    step = max(1, _CHUNK // max(1, math.prod(batch)))
    for start in range(0, n, step):
        stop = min(n, start + step)
        out[..., start:stop] = fn(_bits_range(key, start, stop))
    return out.reshape(batch + shape)


def random_bits(key: torch.Tensor, shape, width: int = 32) -> torch.Tensor:
    """``width``-bit random words (32 or 8), shape ``key.shape[:-1] +
    shape`` (int64).  ``jax.random.bits(key, shape, uint8)`` is the low
    byte of the 32-bit word at the same counter."""
    if width not in (8, 32):
        raise ValueError(f"random_bits takes 8- or 32-bit words, not {width}")
    return _map_bits(key, shape, (lambda b: b) if width == 32
                     else (lambda b: b & 0xFF), torch.int64)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 in [0, 1): mantissa fill of 1.0, minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _unit_to_range(u: torch.Tensor, minval: float, maxval: float):
    """``max(lo, u * (hi - lo) + lo)`` in float32, with Python scalars (a
    device scalar would cost a host-to-device copy per call)."""
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    return torch.clamp(u * float(span) + float(lo), min=float(lo))


def _bits8_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """The low bytes of uint32 words -> bf16 in [0, 1): the top 7 bits of
    each byte fill bf16's mantissa of 1.0, minus 1."""
    f = (((bits & 0xFF) >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16)
    return f - 1.0


def rounded(v: float, dtype) -> float:
    """A Python float rounded to ``dtype``, as JAX converts a weakly typed
    scalar to an array's type."""
    return float(torch.tensor(v, dtype=torch.float64).to(dtype))


def _unit_to_range_bf16(u: torch.Tensor, minval: float, maxval: float):
    """``max(lo, u * (hi - lo) + lo)`` in bf16, each operation rounded."""
    lo = rounded(minval, torch.bfloat16)
    span = rounded(rounded(maxval, torch.bfloat16) - lo, torch.bfloat16)
    return torch.clamp(u * span + lo, min=lo)


def _check_dtype(dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"draws in float32 or bf16, not {dtype}")


def uniform(key: torch.Tensor, shape, minval=0.0, maxval=1.0,
            dtype=torch.float32) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` for float32
    and bf16."""
    _check_dtype(dtype)
    if dtype == torch.bfloat16:
        return _map_bits(key, shape, lambda b: _unit_to_range_bf16(
            _bits8_to_unit(b), minval, maxval), dtype)
    return _map_bits(key, shape, lambda b: _unit_to_range(
        _bits_to_unit(b), minval, maxval), torch.float32)


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


def _fma(a, b, c) -> torch.Tensor:
    """float32 fused multiply-add ``a*b + c`` with one rounding, for float32
    values (tensors, float64 copies of them, or Python floats): the float64
    product of two float32 values is exact, and so is its sum with a float32
    value except in rare double-rounding cases that none of the inputs
    ``erf_inv`` feeds here hit (tests/test_torch_prng.py checks all 2^23
    inputs ``normal`` can take)."""
    def f64(v):
        return v.double() if isinstance(v, torch.Tensor) else v
    return (f64(a) * f64(b) + f64(c)).float()


def _f32(v: float) -> float:
    return float(np.float32(v))


# XLA's float32 log1p for |y| < sqrt(2) - 1 (ElementalIrEmitter::EmitLog1p):
# a Cephes rational, numerator and denominator by Horner with fused
# multiply-adds, coefficients rounded to float32.
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_NUM = tuple(_f32(c) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(_f32(c) for c in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))
# XLA CPU's float32 log (the Cephes/Eigen plog polynomial, p0 .. p8)
_LOG_P = tuple(_f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
_SQRTHF = _f32(0.707106781186547524)
_TINY = float(np.finfo(np.float32).tiny)


def _horner(y: torch.Tensor, coefs) -> torch.Tensor:
    """``((c0*y + c1)*y + c2) ...`` with every step one fused multiply-add
    (XLA starts from 0*y + c0 = c0)."""
    y64 = y.double()
    p = torch.full_like(y, coefs[0])
    for c in coefs[1:]:
        p = _fma(p, y64, c)
    return p


def log_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``log`` (Cephes/Eigen ``plog``), bitwise: split x
    into exponent e and mantissa m in [0.5, 1) (below sqrt(1/2) one octave
    up), a degree-8 polynomial in three Horner chains joined through m^3,
    then ``+ e*q1 - m^2/2 + e*q2`` in XLA's order and fusion."""
    xc = torch.clamp(x, min=_TINY)
    bits = xc.view(torch.int32).to(torch.int64)
    e = ((bits >> 23) - 126).to(torch.float32)
    m = ((bits & 0x807FFFFF) | 0x3F000000).to(torch.int32).view(torch.float32)
    low = m < _SQRTHF
    t = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.to(torch.float32)
    x2 = t * t
    x3 = (x2 * t).double()
    p, t = _LOG_P, t.double()
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _LOG_Q1 * e)
    t = t.float()
    out = ((t - 0.5 * x2) + y) + _LOG_Q2 * e
    out = torch.where(x == math.inf, x, out)
    out = torch.where(x == 0, torch.full_like(out, -math.inf), out)
    return torch.where(x >= 0, out, torch.full_like(out, math.nan))


def log1p_xla(y: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``log1p``, bitwise ``jnp.log1p`` on the CPU: the
    Cephes rational ``y + (-y^2/2 + y^3 N(y)/D(y))`` for |y| < sqrt(2) - 1,
    else ``log_xla(1 + y)``."""
    y = torch.where(y.abs() < _TINY, y * 0.0, y)     # XLA CPU flushes denormals
    y2 = y * y
    small = y + (-0.5 * y2 + (y * y2) * (_horner(y, _LOG1P_NUM)
                                         / _horner(y, _LOG1P_DEN)))
    return torch.where(y.abs() < _LOG1P_SMALL, small, log_xla(1.0 + y))


# XLA's float32 ErfInv (Giles' single-precision approximation); the
# coefficients are XLA's, in Horner order from the highest power.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, bitwise XLA CPU's ``ErfInv``: its
    ``log1p``, a correctly rounded square root (``torch.sqrt`` on the CPU is
    not), and the Horner steps ``c + p*w`` fused into multiply-adds as XLA
    CPU's LLVM backend contracts them."""
    w = -log1p_xla(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    w = w.double()

    def coef(i):
        return torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i])

    p = coef(0)
    for i in range(1, 9):
        p = _fma(p, w, coef(i))
    res = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, res)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = float(np.float32(np.sqrt(2)))


def _normal_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """The float32 normal draw of 32-bit words: ``sqrt(2) · erf_inv`` of
    the uniform their top 23 bits make, as ``jax.random.normal`` forms it."""
    return (erf_inv(_unit_to_range(_bits_to_unit(bits), _NORMAL_LO, 1.0))
            * SQRT2).float()


def normal_root(key: torch.Tensor, shape) -> torch.Tensor:
    """``erf_inv`` of the uniform that :func:`normal`'s words make, before
    its sqrt(2) factor (float32): what XLA CPU multiplies by a scale folded
    with sqrt(2) when it fuses ``scale * normal`` into an axpy."""
    return _map_bits(key, shape, lambda b: erf_inv(_unit_to_range(
        _bits_to_unit(b), _NORMAL_LO, 1.0)).float(), torch.float32)


def normal(key: torch.Tensor, shape, scale: float | None = None,
           dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``; with ``scale`` and
    ``dtype``, ``(scale * normal(key, shape)).to(dtype)`` formed chunk by
    chunk, so that a bf16 draw never holds a float32 copy of itself."""
    def fn(b):
        z = _normal_of_bits(b)
        return (z if scale is None else scale * z).to(dtype)
    return _map_bits(key, shape, fn, dtype)


def _gumbel_bf16(bits: torch.Tensor) -> torch.Tensor:
    """The bf16 Gumbel of 8-bit words: each ``log`` XLA CPU's float32
    ``log`` of the bf16 input, rounded to bf16 (128 distinct values)."""
    u = _unit_to_range_bf16(_bits8_to_unit(bits), _TINY, 1.0)
    inner = (-log_xla(u.float())).to(torch.bfloat16)
    return (-log_xla(inner.float())).to(torch.bfloat16)


def gumbel(key: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, dtype)`` in its default "low" mode:
    ``-log(-log(uniform(tiny, 1)))``, through XLA CPU's float32 ``log``
    (in bf16: of 8-bit words, rounded after each ``log``)."""
    _check_dtype(dtype)
    if dtype == torch.bfloat16:
        return _map_bits(key, shape, _gumbel_bf16, dtype)
    return _map_bits(key, shape, lambda b: -log_xla(-log_xla(_unit_to_range(
        _bits_to_unit(b), _TINY, 1.0))), torch.float32)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, one key
    per row: ``key`` (..., 2) with ``...`` = ``logits.shape[:-1]``.  The
    Gumbel-max trick in the logits' type (float32 or bf16: the Gumbels
    drawn in it, their sum with the logits rounded to it), ties to the
    first index as ``jnp.argmax``."""
    g = gumbel(key, logits.shape[-1:], logits.dtype)
    return torch.argmax(g + logits, dim=-1)
