"""Mamba-1 selective scan (``csrc/selective_scan.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/selective_scan.py``
``selective_scan``:

    h_t = a_t ⊙ h_{t−1} + bx_t,      y_t[d] = Σ_n h_t[d, n] · c_t[n]

a, bx (B, T, D, N), c (B, T, N), h0 (B, D, N) -> y (B, T, D), h_last
(B, D, N), all float32.  The scan has no per-client weights: a caller with
a client axis folds it into B.

Bound on the H100: HBM bytes, one read of a and bx (and of c, h0), one
write of y and h_last.  One thread owns one state element and walks T in
its own loop; the readout over n is a warp-shuffle tree (see the ``.cu``
file).  N must be a power of two no larger than 32; any other N is refused.

The wrapper runs its plain PyTorch version for CPU tensors only (which
autograd differentiates); for CUDA tensors it launches the kernel or
raises.  The kernel has no backward: a CUDA call whose inputs need a
gradient raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: state sizes the kernel takes (the N lanes of a channel share a warp)
SUPPORTED_N = (1, 2, 4, 8, 16, 32)


def selective_scan_plain(a, bx, c, h0):
    """Plain PyTorch scan (the CPU path and the card's oracle): a loop over
    t, as the JAX package's sequential reference."""
    B, T, D, _ = a.shape
    h = h0.float()
    y = torch.empty((B, T, D), dtype=torch.float32, device=a.device)
    for t in range(T):
        h = a[:, t].float() * h + bx[:, t].float()
        y[:, t] = (h * c[:, t, None, :].float()).sum(-1)
    return y, h


def selective_scan(a, bx, c, h0):
    if a.device.type == "cpu":
        return selective_scan_plain(a, bx, c, h0)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (a, bx, c, h0)):
        raise NotImplementedError(
            "selective_scan: the CUDA kernel has no backward, so a "
            "first-order step cannot run through a Mamba layer on the card "
            "(ROADMAP Queue 2: a backward for selective_scan)")
    B, T, D, N = a.shape
    for t, name in ((a, "a"), (bx, "bx"), (c, "c"), (h0, "h0")):
        if t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError(f"{name}: float32 CUDA tensor required, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(bx.shape) != (B, T, D, N) or tuple(c.shape) != (B, T, N) \
            or tuple(h0.shape) != (B, D, N):
        raise ValueError(f"shapes do not agree: a {tuple(a.shape)}, bx "
                         f"{tuple(bx.shape)}, c {tuple(c.shape)}, h0 "
                         f"{tuple(h0.shape)}")
    if N not in SUPPORTED_N:
        raise ValueError(f"selective_scan: d_state N={N} is not a power of "
                         f"two <= 32 (the kernel takes {SUPPORTED_N})")
    if not (1 <= B <= 65535 and T >= 1 and D >= 1):
        raise ValueError(f"unsupported shape: B={B}, T={T}, D={D}")
    lib = build.load("selective_scan")
    y = torch.empty((B, T, D), dtype=torch.float32, device=a.device)
    h_last = torch.empty((B, D, N), dtype=torch.float32, device=a.device)
    err = lib.selective_scan_f32(a.data_ptr(), bx.data_ptr(), c.data_ptr(),
                                 h0.data_ptr(), y.data_ptr(),
                                 h_last.data_ptr(), B, T, D, N,
                                 build.stream_of(a))
    build.check(err, "selective_scan")
    build.LAUNCHES["selective_scan"] += 1
    return y, h_last
