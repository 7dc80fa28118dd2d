"""Public dispatch layer for the port's kernels.

The counterpart of ``repro/kernels/ops.py``.  There is no backend knob:
each op dispatches on the device of its tensors.  A CPU tensor runs the
kernel's plain PyTorch version (the CPU tests); a CUDA tensor launches the
hand-written Hopper kernel or raises.  There is no fallback from a failed
kernel to the plain version.

Shapes carry an explicit leading client axis where JAX would ``vmap``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rank1_matmul import rank1_matmul, \
    rank1_matmul_expert, rank1_matmul_t
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.kernels.subcge_apply import subcge_apply, subcge_apply_epochs

__all__ = ["rank1_matmul", "rank1_matmul_expert", "rank1_matmul_t",
           "selective_scan", "subcge_apply", "subcge_apply_epochs",
           "subcge_delta"]


def subcge_delta(U, A, V, dtype):
    """U A V^T alone (no base weight), in ``dtype``: U (n, r), A (*B, r, r),
    V (m, r) -> (*B, n, m).  A zero W goes through ``subcge_apply`` (a
    delta is not a hot path; one kernel serves both)."""
    W = torch.zeros(tuple(A.shape[:-2]) + (U.shape[-2], V.shape[-2]),
                    dtype=dtype, device=A.device)
    return subcge_apply(W, U, A, V, inplace=True)
