"""Fused SubCGE weight updates ``W + U A V^T`` (``csrc/subcge_apply.cu``).

Replaces the Pallas TPU kernels ``repro/kernels/subcge_apply.py``
``subcge_apply`` and ``subcge_apply_epochs``:

* ``subcge_apply``        W (*B,n,m) + U (n,r) A (*B,r,r) V (m,r)^T
* ``subcge_apply_epochs`` W (*B,n,m) + Σ_e U (E,n,r)[e] A (E,*B,r,r)[e] V (E,m,r)[e]^T

Instance dims ``*B`` (clients x stacked layers) collapse into one axis.
Bound on the H100: HBM bytes, one read and one write of W.  Two kernels,
picked by W's type and the rank with no knob (:func:`uses_tensor_cores`):

* ``subcge_stream_kernel`` (float32 W, r <= 32, ``MAX_RANK``): one
  streaming pass over a persistent grid; each block walks a contiguous
  range of (instance, column chunk, row tile), keeps A V^T of the current
  (instance, chunk) in shared memory, copies the next tile of W into
  shared memory (16-byte ``cp.async``) while it forms the current tile's
  delta with float32 FMAs, and stores W + delta with the evict-first hint.
  Its geometry is :func:`update_plan`.
* ``update_tc_kernel`` (bf16 W at any rank, float32 W at r > 32): the
  delta ``U (blockdiag(A_e) [V_1 ... V_E]^T)`` on the tensor cores, one
  pass over k = E·rp (each epoch's r padded with zeros to rp, a multiple
  of 8), in TF32 split in three (hi·hi + hi·lo + lo·hi, float32 sums) so
  that it keeps float32 accuracy; W through a TMA ring fed by a producer
  warp group (16-byte ``cp.async`` over the leaf's flat view where TMA
  cannot describe it), stored by TMA.  Its geometry is :func:`stream_plan`.

Unlike the JAX package, ``subcge_apply_epochs`` launches its own kernel for
E = 1 as well (the Pallas wrapper delegates that case to
``subcge_apply``); the arithmetic is the same.

Types.  W (and the result) are float32 or bfloat16; U, A and V are
float32, as the reference's are.  The delta is formed to float32 accuracy,
added to ``f32(W)`` and cast to W's type once (round to nearest even), the
Pallas kernel's arithmetic; in bf16 W moves 2 + 2 bytes an element, so the
bound halves.  bf16 launches count under the op's name with ``_bf16``
appended.

``inplace=True`` writes the result into W (the port's counterpart of the
JAX package's donated buffers) and returns it.  Each wrapper runs its plain
PyTorch version for CPU tensors only; for CUDA tensors it launches a
kernel or raises.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.kernels import build

#: threads of a block, rows each thread owns in a tile (``NT``, ``RPT`` in
#: the .cu file), and the largest rank the float32 stream takes
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


def uses_tensor_cores(bf16: bool, r: int) -> bool:
    """Whether a launch takes ``update_tc_kernel`` (bf16 W at any rank,
    float32 W past ``MAX_RANK``) rather than the float32 stream."""
    return bf16 or r > MAX_RANK


#: ``update_tc_kernel``'s tile (``BM`` x ``BN``), the largest k group of
#: A V^T it keeps in shared memory (``KMAX``: 32 KB of hi and 32 KB of lo),
#: and the q of A and V staged at a time to form it (``QC``)
TC_ROWS, TC_COLS, TC_KMAX, TC_QC = 128, 64, 128, 16
#: its persistent grid: one block on each of 132 SMs
TC_SLOTS = 132
#: W tiles in the ring, by the element size of W
TC_STAGES = {2: 6, 4: 4}
#: one 32-k block of a chunk's A V^T, hi or lo (64 rows of 128 bytes)
TC_KB_BYTES = TC_COLS * 128


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Geometry of one ``subcge_update_tc_*`` launch.  Each epoch's rank r
    is padded with zeros to ``rp``; ``k = E · rp`` is walked in
    ``groups`` groups of ``kgroup``.  An instance's ``tiles`` row tiles
    (``TC_ROWS`` rows) and ``chunks`` column chunks (``TC_COLS`` columns)
    are walked in super-chunks of ``sub`` chunks (the last may hold
    fewer): row tile by row tile, each row tile's chunks of the
    super-chunk side by side (``tc::Cursor``).  A V^T of a super-chunk's
    chunks (``kgroup`` rounded up to 32 rows each, TF32 hi and lo) fills
    the kernel's 64 KB; it is formed once per (instance, super-chunk) when
    ``groups == 1``, else per tile and group.  Block ``j`` takes tiles
    ``[j · per, (j + 1) · per)``, cut at the last."""
    rp: int
    k: int
    kgroup: int
    groups: int
    tiles: int
    chunks: int
    sub: int
    per: int
    blocks: int
    stages: int
    smem_bytes: int


def tc_smem_bytes(esz: int) -> int:
    """Shared memory of ``update_tc_kernel`` for W of ``esz``-byte elements
    (``Shape<T>::SMEM``): the ring of W tiles, each row room for its 16-byte
    pieces of the flat view (one more than the 64 columns need, since a
    row may start anywhere in its first piece); A V^T hi and lo; the A and
    V staging; 1024 bytes to align the ring for the 128-byte swizzle."""
    stage = TC_ROWS * (TC_COLS * esz // 16 + 1) * 16
    av = 2 * TC_KMAX // 32 * TC_KB_BYTES
    staging = 4 * (TC_COLS * (TC_QC + 1) + TC_QC * TC_KMAX)
    return TC_STAGES[esz] * stage + av + staging + 1024


@functools.lru_cache(maxsize=1024)
def stream_plan(nb: int, n: int, m: int, r: int, E: int,
                esz: int) -> StreamPlan:
    """``update_tc_kernel``'s geometry for ``nb`` instances of an (n, m)
    leaf of ``esz``-byte elements (2: bf16, 4: float32), rank r, E epochs.
    A pure function of the shape.  Any r >= 1 and E >= 1: k past
    ``TC_KMAX`` takes several groups, still one pass over W.  Raises
    ``ValueError`` on what the kernel refuses: r < 1, an empty shape, an
    element size other than 2 or 4, more tiles than a 32-bit block range
    holds."""
    if r < 1:
        raise ValueError(f"unsupported rank r={r} (r >= 1)")
    if min(nb, n, m, E) < 1:
        raise ValueError(f"empty update: instances={nb}, n={n}, m={m}, E={E}")
    if esz not in TC_STAGES:
        raise ValueError(f"W of {esz}-byte elements (bf16 or float32 only)")
    rp = _cdiv(r, 8) * 8
    k = E * rp
    kgroup = min(k, TC_KMAX)
    tiles, chunks = _cdiv(n, TC_ROWS), _cdiv(m, TC_COLS)
    total = nb * chunks * tiles
    per = _cdiv(total, min(total, TC_SLOTS))
    if per > 2**31 - 1:
        raise ValueError(f"update too large: {total} tiles")
    sub = max(1, 4 // _cdiv(kgroup, 32))
    return StreamPlan(rp, k, kgroup, _cdiv(k, kgroup), tiles, chunks, sub,
                      per, _cdiv(total, per), TC_STAGES[esz],
                      tc_smem_bytes(esz))



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
    out = W if inplace else torch.empty_like(W)
    Of = out.reshape(nb, n, m)
    lib = build.load("subcge_apply")
    bf16 = W.dtype == torch.bfloat16
    ptrs = (Wf.data_ptr(), Of.data_ptr(), U.data_ptr(), A.data_ptr(),
            V.data_ptr())
    if uses_tensor_cores(bf16, r):
        plan = stream_plan(nb, n, m, r, E, W.element_size())
        fn = lib.subcge_update_tc_bf16 if bf16 else lib.subcge_update_tc_f32
        err = fn(*ptrs, E, nb, n, m, r, plan.rp, plan.k, plan.kgroup,
                 plan.chunks, plan.tiles, plan.sub, plan.per, plan.blocks,
                 plan.smem_bytes, Wf.stride(0), Of.stride(0),
                 build.stream_of(W))
    else:
        plan = update_plan(nb, n, m, r, E)
        err = lib.subcge_apply_f32(
            *ptrs, E, nb, n, m, r, plan.bc.bit_length() - 1, plan.chunks,
            plan.per, plan.blocks, plan.groups, plan.smem_bytes,
            Wf.stride(0), Of.stride(0), build.stream_of(W))
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
