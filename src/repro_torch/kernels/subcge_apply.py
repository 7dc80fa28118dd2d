"""Fused SubCGE weight updates ``W + U A V^T`` (``csrc/subcge_apply.cu``).

Replaces the Pallas TPU kernels ``repro/kernels/subcge_apply.py``
``subcge_apply`` and ``subcge_apply_epochs``:

* ``subcge_apply``        W (*B,n,m) + U (n,r) A (*B,r,r) V (m,r)^T
* ``subcge_apply_epochs`` W (*B,n,m) + Σ_e U (E,n,r)[e] A (E,*B,r,r)[e] V (E,m,r)[e]^T

Instance dims ``*B`` (clients x stacked layers) collapse into one axis.
Bound on the H100: HBM bytes, one read and one write of W (4·E flops per
byte at r = 16, below the float32 ridge).  The kernel is one streaming
pass over a persistent grid: each block walks a contiguous range of
(instance, column chunk, row tile) and keeps A V^T of the current
(instance, chunk) in shared memory.  It copies the next tile of W into
shared memory (16-byte ``cp.async``) while it forms the current tile's
delta in registers, and stores W + delta with the evict-first hint.
Epochs loop inside the tile, so W is streamed once for any E.  The
geometry (chunk width, tiles per block, epochs per shared-memory group) is
the pure function :func:`update_plan`.  Unlike the JAX package,
``subcge_apply_epochs`` launches its own kernel for E = 1 as well (the
Pallas wrapper delegates that case to ``subcge_apply``); the arithmetic is
the same.

Types.  W (and the result) are float32 or bfloat16; U, A and V are
float32, as the reference's are.  The delta is formed in float32, added to
``f32(W)`` and cast to W's type once (round to nearest even), the Pallas
kernel's arithmetic; in bf16 W moves 2 + 2 bytes an element, so the bound
halves.  bf16 launches count under the op's name with ``_bf16`` appended.

Rank.  The kernel takes r <= 32 (``MAX_RANK``); the wrappers take any
r >= 1, as the Pallas kernel does.  Above 32, :func:`rank_blocks` pads r
with zeros to a multiple of 32 and cuts each epoch's U A V^T into its
(r/32)^2 blocks of rank 32, U A V^T = Σ_ij U_i A_ij V_j^T, which the
kernel's epoch loop takes as E·(r/32)^2 terms: W is still streamed once,
and the padding adds exact zeros.  At r = 64 that is 4 × 32 FMAs an
element where a rank-64 pass needs 64.

``inplace=True`` writes the result into W (the port's counterpart of the
JAX package's donated buffers) and returns it.  Each wrapper runs its plain
PyTorch version for CPU tensors only; for CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.kernels import build

#: threads of a block, rows each thread owns in a tile (``NT``, ``RPT`` in
#: the .cu file), and the largest rank the kernel takes
THREADS, ROWS_PER_THREAD, MAX_RANK = 256, 4, 32
#: chunk widths the kernel takes (``bc``: bc / 4 lanes cover a row)
CHUNK_WIDTHS = (4, 8, 16, 32, 64, 128)
#: floats of A V^T a block keeps (64 KB): G = this // (r · bc) epochs
AV_FLOATS = 16384
#: the ring of W tiles in shared memory: 2 stages x 4 rows x 256 threads x 16 B
RING_BYTES = 2 * ROWS_PER_THREAD * THREADS * 16
#: the persistent grid: three blocks on each of 132 SMs
SLOTS = 3 * 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class UpdatePlan:
    """Geometry of one ``subcge_apply_f32`` launch.  Tile ``g`` is row tile
    ``g % tiles`` (``tile_rows`` rows) of column chunk ``g // tiles %
    chunks`` (``bc`` columns) of instance ``g // (tiles · chunks)``; block
    ``k`` takes tiles ``[k · per, (k + 1) · per)`` of them, cut at the
    last."""
    bc: int
    tile_rows: int
    tiles: int
    chunks: int
    per: int
    blocks: int
    groups: int         # G: epochs whose A V^T a block keeps at once
    smem_bytes: int


@functools.lru_cache(maxsize=1024)
def update_plan(nb: int, n: int, m: int, r: int, E: int) -> UpdatePlan:
    """The kernel's geometry for ``nb`` instances of an (n, m) leaf, rank r,
    E epochs.  A pure function of the shape.

    The chunk width is the widest that pads m by at most 1/8 over the
    least padding any width gives (m = 4, 16, 32 take one chunk of their
    own width, m = 288 five of 64): a narrower chunk reads U's rows more
    often for the same bytes of W, and masked columns cost only FMAs.  The
    tiles are dealt in equal contiguous ranges to at most ``SLOTS`` blocks.
    Raises ``ValueError`` on what the kernel refuses: r outside [1, 32] or
    an empty shape."""
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"unsupported rank r={r} (1 <= r <= {MAX_RANK})")
    if min(nb, n, m, E) < 1:
        raise ValueError(f"empty update: instances={nb}, n={n}, m={m}, E={E}")
    padded = {bc: _cdiv(m, bc) * bc for bc in CHUNK_WIDTHS}
    least = min(padded.values())
    bc = max(w for w in CHUNK_WIDTHS if 8 * padded[w] <= 9 * least)
    tile_rows = THREADS // 32 * ROWS_PER_THREAD * (128 // bc)
    tiles, chunks = _cdiv(n, tile_rows), _cdiv(m, bc)
    total = nb * chunks * tiles
    per = _cdiv(total, min(total, SLOTS))
    if per > 2**31 - 1:
        raise ValueError(f"update too large: {total} tiles")
    groups = min(E, AV_FLOATS // (r * bc))
    smem = RING_BYTES + 4 * (groups * r * bc + r * r + bc * (r | 1))
    return UpdatePlan(bc, tile_rows, tiles, chunks, per, _cdiv(total, per),
                      groups, smem)


def rank_blocks(U, A, V):
    """(U', A', V') of rank at most MAX_RANK with the same
    ``Σ_e U_e A_e V_e^T``, for U (E, n, r), A (E, *B, r, r), V (E, m, r):
    r padded with zeros to q·MAX_RANK and each epoch cut into q² terms
    ``U_i A_ij V_j^T`` (term (e, i, j) at e·q² + i·q + j).  r <= MAX_RANK
    returns the inputs."""
    E, n, r = U.shape
    if r <= MAX_RANK:
        return U, A, V
    q, R = _cdiv(r, MAX_RANK), MAX_RANK
    batch = tuple(A.shape[1:-2])
    pad = q * R - r
    Ub = torch.nn.functional.pad(U, (0, pad)).reshape(E, n, q, R)
    Vb = torch.nn.functional.pad(V, (0, pad)).reshape(E, V.shape[1], q, R)
    Ub = Ub.permute(0, 2, 1, 3)[:, :, None].expand(E, q, q, n, R)
    Vb = Vb.permute(0, 2, 1, 3)[:, None].expand(E, q, q, V.shape[1], R)
    Ab = torch.nn.functional.pad(A, (0, pad, 0, pad)).reshape(
        E, *batch, q, R, q, R)
    nd = len(batch)
    Ab = Ab.permute(0, nd + 1, nd + 3, *range(1, nd + 1), nd + 2, nd + 4)
    return (Ub.reshape(E * q * q, n, R), Ab.reshape(E * q * q, *batch, R, R),
            Vb.reshape(E * q * q, V.shape[1], R))


def subcge_apply_epochs_plain(W, U, A, V, *, inplace: bool = False):
    """Plain PyTorch ``W + Σ_e U_e A_e V_e^T``: the delta in float32, added
    to ``f32(W)``, cast to W's type once."""
    delta = torch.einsum("enr,e...rs,ems->...nm", U.float(), A.float(),
                         V.float())
    if W.dtype == torch.float32:
        return W.add_(delta) if inplace else W + delta
    out = (W.float() + delta).to(W.dtype)
    return W.copy_(out) if inplace else out


def subcge_apply_plain(W, U, A, V, *, inplace: bool = False):
    """Plain PyTorch ``W + U A V^T`` in float32."""
    return subcge_apply_epochs_plain(W, U[None], A[None], V[None],
                                     inplace=inplace)


def _launch(W, U, A, V, inplace, name):
    U, A, V = rank_blocks(U, A, V)
    E, n, r = U.shape
    m = V.shape[1]
    batch = tuple(W.shape[:-2])
    nb = math.prod(batch)
    for t, nm in ((W, "W"), (U, "U"), (A, "A"), (V, "V")):
        want = (torch.float32, torch.bfloat16) if nm == "W" \
            else (torch.float32,)
        if t.dtype not in want or not t.is_cuda:
            raise ValueError(f"{nm}: {' or '.join(map(str, want))} CUDA "
                             f"tensor required, got {t.dtype} on {t.device}")
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
    plan = update_plan(nb, n, m, r, E)
    out = W if inplace else torch.empty_like(W)
    Of = out.reshape(nb, n, m)
    lib = build.load("subcge_apply")
    bf16 = W.dtype == torch.bfloat16
    fn = lib.subcge_apply_bf16 if bf16 else lib.subcge_apply_f32
    err = fn(
        Wf.data_ptr(), Of.data_ptr(), U.data_ptr(), A.data_ptr(), V.data_ptr(),
        E, nb, n, m, r, plan.bc.bit_length() - 1, plan.chunks, plan.per,
        plan.blocks, plan.groups, plan.smem_bytes, Wf.stride(0), Of.stride(0),
        build.stream_of(W))
    name += "_bf16" if bf16 else ""
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
