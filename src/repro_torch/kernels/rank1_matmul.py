"""Fused rank-1-perturbed matmuls of the ZO dual forward (``csrc/rank1_matmul.cu``).

Replaces the Pallas TPU kernels ``repro/kernels/rank1_matmul.py``
``rank1_matmul``, ``rank1_matmul_t`` and ``rank1_matmul_expert``.  The port
batches them over a leading client axis (JAX gets it from ``vmap``):

* ``rank1_matmul``   x (C,M,K), W (C,K,N), u (C,K), v (C,N), s (C,)
                     -> y[c] = x[c] W[c] + s[c] (x[c]·u[c]) v[c]^T
* ``rank1_matmul_t`` x (C,M,K), W (C,O,K), u (C,O), v (C,K), s (C,)
                     -> y[c] = x[c] W[c]^T + s[c] (x[c]·v[c]) u[c]^T
* ``rank1_matmul_expert``
                     x (C,E,M,K), W (C,E,K,N), u (C,E,K), v (C,E,N), s (C,)
                     -> y[c,e] = x[c,e] W[c,e] + s[c] (x[c,e]·u[c,e]) v[c,e]^T

The expert axis of u and v comes before the row, where the JAX kernel takes
``u (K, E)`` and ``v (N, E)`` with the expert last: each (client, expert)
pair then reads one contiguous column of its subspace.

Bound on the H100: float32 CUDA-core FLOPs (see the source note in the
``.cu`` file); no TF32.  W may be a strided view of the stacked parameters
(its client and expert strides are passed to the kernel); the inner (K, N)
/ (O, K) matrix must be contiguous.

Each wrapper runs its plain PyTorch version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def rank1_matmul_plain(x, W, u, v, s):
    """Plain PyTorch rank1_matmul (the CPU path and the card's oracle)."""
    y = torch.bmm(x, W)
    xu = torch.bmm(x, u.unsqueeze(-1))                     # (C, M, 1)
    return y + (s[:, None, None] * xu) * v[:, None, :]


def rank1_matmul_t_plain(x, W, u, v, s):
    """Plain PyTorch rank1_matmul_t (the CPU path and the card's oracle)."""
    y = torch.bmm(x, W.transpose(1, 2))
    xv = torch.bmm(x, v.unsqueeze(-1))                     # (C, M, 1)
    return y + (s[:, None, None] * xv) * u[:, None, :]


def rank1_matmul_expert_plain(x, W, u, v, s):
    """Plain PyTorch rank1_matmul_expert (the CPU path and the card's oracle)."""
    y = torch.matmul(x, W)
    xu = torch.matmul(x, u.unsqueeze(-1))                  # (C, E, M, 1)
    return y + (s[:, None, None, None] * xu) * v[:, :, None, :]


def _check_f32_cuda(**tensors):
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError(f"{name}: float32 CUDA tensor required, got "
                             f"{t.dtype} on {t.device}")


def _check(x, W, cvec, ovec, s, n_out, trans):
    C, M, K = x.shape
    wshape = (C, n_out, K) if trans else (C, K, n_out)
    if tuple(W.shape) != wshape:
        raise ValueError(f"W shape {tuple(W.shape)} != {wshape}")
    _check_f32_cuda(x=x, W=W, cvec=cvec, ovec=ovec, s=s)
    if W.stride(-1) != 1 or W.stride(-2) != W.shape[-1]:
        raise ValueError("W: inner matrix must be contiguous")
    if x.stride(-1) != 1 or x.stride(-2) != K:
        raise ValueError("x: inner matrix must be contiguous")
    if cvec.shape != (C, K) or ovec.shape != (C, n_out) or s.shape != (C,):
        raise ValueError("u/v/s shapes do not match x and W")
    if cvec.stride(-1) != 1 or ovec.stride(-1) != 1 or s.stride(0) != 1:
        raise ValueError("u/v/s must be contiguous along their last axis")
    if (M + 63) // 64 > 65535 or C > 65535:
        raise ValueError("grid too large")


def _launch(x, W, cvec, ovec, s, n_out, trans, name):
    _check(x, W, cvec, ovec, s, n_out, trans)
    lib = build.load("rank1_matmul")
    C, M, K = x.shape
    y = torch.empty((C, M, n_out), dtype=torch.float32, device=x.device)
    err = lib.rank1_matmul_f32(
        x.data_ptr(), W.data_ptr(), cvec.data_ptr(), ovec.data_ptr(),
        s.data_ptr(), y.data_ptr(), C, M, n_out, K, x.stride(0), W.stride(0),
        cvec.stride(0), ovec.stride(0), y.stride(0), int(trans),
        build.stream_of(x))
    build.check(err, name)
    build.LAUNCHES[name] += 1
    return y


def rank1_matmul(x, W, u, v, s):
    if x.device.type == "cpu":
        return rank1_matmul_plain(x, W, u, v, s)
    return _launch(x, W, u, v, s, W.shape[-1], False, "rank1_matmul")


def rank1_matmul_t(x, W, u, v, s):
    if x.device.type == "cpu":
        return rank1_matmul_t_plain(x, W, u, v, s)
    return _launch(x, W, v, u, s, W.shape[-2], True, "rank1_matmul_t")


def rank1_matmul_expert(x, W, u, v, s):
    if x.device.type == "cpu":
        return rank1_matmul_expert_plain(x, W, u, v, s)
    C, E, M, K = x.shape
    N = W.shape[-1]
    _check_f32_cuda(x=x, W=W, u=u, v=v, s=s)
    if tuple(W.shape) != (C, E, K, N) or u.shape != (C, E, K) \
            or v.shape != (C, E, N) or s.shape != (C,):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, W "
                         f"{tuple(W.shape)}, u {tuple(u.shape)}, v "
                         f"{tuple(v.shape)}, s {tuple(s.shape)}")
    for t, name, row in ((x, "x", K), (W, "W", N)):
        if t.stride(-1) != 1 or t.stride(-2) != row:
            raise ValueError(f"{name}: inner matrix must be contiguous")
    if u.stride(-1) != 1 or v.stride(-1) != 1 or s.stride(0) != 1:
        raise ValueError("u/v/s must be contiguous along their last axis")
    if (M + 63) // 64 > 65535 or C * E > 65535:
        raise ValueError("grid too large")
    lib = build.load("rank1_matmul")
    y = torch.empty((C, E, M, N), dtype=torch.float32, device=x.device)
    err = lib.rank1_matmul_expert_f32(
        x.data_ptr(), W.data_ptr(), u.data_ptr(), v.data_ptr(), s.data_ptr(),
        y.data_ptr(), C, E, M, N, K, *x.stride()[:2], *W.stride()[:2],
        *u.stride()[:2], *v.stride()[:2], *y.stride()[:2], build.stream_of(x))
    build.check(err, "rank1_matmul_expert")
    build.LAUNCHES["rank1_matmul_expert"] += 1
    return y
