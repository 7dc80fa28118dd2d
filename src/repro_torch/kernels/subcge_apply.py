"""Fused SubCGE weight updates ``W + U A V^T`` (``csrc/subcge_apply.cu``).

Replaces the Pallas TPU kernels ``repro/kernels/subcge_apply.py``
``subcge_apply`` and ``subcge_apply_epochs``:

* ``subcge_apply``        W (*B,n,m) + U (n,r) A (*B,r,r) V (m,r)^T
* ``subcge_apply_epochs`` W (*B,n,m) + Σ_e U (E,n,r)[e] A (E,*B,r,r)[e] V (E,m,r)[e]^T

Instance dims ``*B`` (clients x stacked layers) collapse into one grid axis.
Bound on the H100: HBM bytes, one read and one write of W; the kernel loops
over epochs inside each tile so W is streamed once for any E.  Unlike the
JAX package, ``subcge_apply_epochs`` launches its own kernel for E = 1 as
well (the Pallas wrapper delegates that case to ``subcge_apply``); the
arithmetic is the same.

``inplace=True`` writes the result into W (the port's counterpart of the
JAX package's donated buffers) and returns it.  Each wrapper runs its plain
PyTorch version for CPU tensors only; for CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build


def subcge_apply_epochs_plain(W, U, A, V, *, inplace: bool = False):
    """Plain PyTorch ``W + Σ_e U_e A_e V_e^T`` in float32."""
    delta = torch.einsum("enr,e...rs,ems->...nm", U.float(), A.float(),
                         V.float())
    if inplace:
        return W.add_(delta.to(W.dtype))
    return W + delta.to(W.dtype)


def subcge_apply_plain(W, U, A, V, *, inplace: bool = False):
    """Plain PyTorch ``W + U A V^T`` in float32."""
    return subcge_apply_epochs_plain(W, U[None], A[None], V[None],
                                     inplace=inplace)


def _launch(W, U, A, V, inplace, name):
    E, n, r = U.shape
    m = V.shape[1]
    batch = tuple(W.shape[:-2])
    nb = math.prod(batch)
    for t, nm in ((W, "W"), (U, "U"), (A, "A"), (V, "V")):
        if t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError(f"{nm}: float32 CUDA tensor required, got "
                             f"{t.dtype} on {t.device}")
    if tuple(W.shape[-2:]) != (n, m) or V.shape != (E, m, r) \
            or tuple(A.shape) != (E,) + batch + (r, r):
        raise ValueError("W/U/A/V shapes do not agree")
    if not (U.is_contiguous() and V.is_contiguous() and A.is_contiguous()):
        raise ValueError("U, A and V must be contiguous")
    Wf = W.reshape(nb, n, m)
    if Wf.stride(-1) != 1 or Wf.stride(-2) != m:
        raise ValueError("W: inner matrix must be contiguous")
    if inplace and Wf.data_ptr() != W.data_ptr():
        raise ValueError("inplace update needs a W whose batch dims flatten")
    if not 1 <= r <= 32 or (n + 31) // 32 > 65535 or nb > 65535:
        raise ValueError(f"unsupported shape: r={r}, n={n}, instances={nb}")
    out = W if inplace else torch.empty_like(W)
    Of = out.reshape(nb, n, m)
    lib = build.load("subcge_apply")
    err = lib.subcge_apply_f32(Wf.data_ptr(), Of.data_ptr(), U.data_ptr(),
                               A.data_ptr(), V.data_ptr(), E, nb, n, m, r,
                               Wf.stride(0), Of.stride(0), build.stream_of(W))
    build.check(err, name)
    build.LAUNCHES[name] += 1
    return out


def subcge_apply(W, U, A, V, *, inplace: bool = False):
    if W.device.type == "cpu":
        return subcge_apply_plain(W, U, A, V, inplace=inplace)
    return _launch(W, U[None], A[None], V[None], inplace, "subcge_apply")


def subcge_apply_epochs(W, U, A, V, *, inplace: bool = False):
    if W.device.type == "cpu":
        return subcge_apply_epochs_plain(W, U, A, V, inplace=inplace)
    out = _launch(W, U, A, V, inplace, "subcge_apply_epochs")
    build.EPOCH_LAUNCHES[int(U.shape[0])] += 1
    return out
