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
raises.  A CUDA call whose inputs need a gradient goes through
:class:`SelectiveScan`, whose backward is the hand-written reverse scan
``csrc/selective_scan_bwd.cu`` (counted as ``selective_scan_bwd``): what
the JAX package gets from ``jax.grad`` through ``_ssm_chunked``
(``repro/models/layers.py:327``).  It reads a and bx from HBM once and
writes da and dbx once whenever T fits a chunk: a producer warp moves
tiles of 128 state elements × up to 64 steps in and out of a two-stage
shared-memory ring by TMA, consumer warps recompute the forward and walk
back there, and dc is summed in float64 through at most 128 partials per
(b, t, n).  Its geometry is the pure function :func:`scan_bwd_plan`.  Its
plain version, :func:`selective_scan_bwd_plain`, is what the tests and
``chip_smoke.py`` hold it against.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import build

#: state sizes the kernel takes (the N lanes of a channel share a warp)
SUPPORTED_N = (1, 2, 4, 8, 16, 32)
#: the backward's tile: state elements along D·N (one thread each) and the
#: most time steps it holds (``COLS``, ``CHUNK`` of selective_scan_bwd.cu)
BWD_COLS, BWD_CHUNK = 128, 64
#: blocks per batch row at most, each leaving one float64 dc partial per
#: (t, n): a quarter of the 512 of the one-thread-per-element design at
#: D = 8192, N = 16
BWD_MAX_PARTIALS = 128
#: shared memory a block may use on sm_90
SMEM_LIMIT = 232_448


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_shape(B, T, D, N) -> None:
    if N not in SUPPORTED_N:
        raise ValueError(f"selective_scan: d_state N={N} is not a power of "
                         f"two <= 32 (the kernel takes {SUPPORTED_N})")
    if not (1 <= B <= 65535 and T >= 1 and D >= 1):
        raise ValueError(f"unsupported shape: B={B}, T={T}, D={D}")


@dataclasses.dataclass(frozen=True)
class ScanBwdPlan:
    """Geometry of one ``selective_scan_bwd_f32`` launch.  A batch row's D·N
    state elements fall in ``tiles`` tiles of ``cols``; block k of the row
    walks tiles k, k + partials, k + 2 · partials, ... (at most ``per``),
    each over the ``chunks`` chunks of at most ``chunk`` steps, the last
    chunk first.  A ring stage holds ``rows`` = min(T, chunk) steps."""
    cols: int
    chunk: int
    rows: int
    chunks: int
    tiles: int
    per: int
    partials: int       # blocks per batch row = dc partials per (b, t, n)
    bulk: bool          # TMA and bulk copies (D % 4 == 0, N >= 4)
    smem_bytes: int
    part_shape: tuple   # float64 dc partials (B, T, partials, N)
    ckpt_shape: tuple   # float32 h at chunk starts after the first


@functools.lru_cache(maxsize=256)
def scan_bwd_plan(B: int, T: int, D: int, N: int) -> ScanBwdPlan:
    """The backward kernel's geometry at (B, T, D, N).  A pure function of
    the shape.

    Tiles are dealt round-robin to at most ``BWD_MAX_PARTIALS`` blocks per
    batch row, so that the blocks in flight read neighbouring runs.  The
    shared memory is two ring stages, each a tile's a and bx (rows × cols
    floats each), dy (rows × cols / N), c (rows × N), start state and
    dh_last (cols each), every part padded to 128 bytes, then the block's
    float64 dc partials (rows × N) and four mbarriers.  A T past ``chunk``
    takes ceil(T / chunk) chunks and a checkpoint buffer (B, chunks − 1, D,
    N).  The tiles go by TMA and bulk copies where every row is a multiple
    of 16 bytes (D % 4 == 0, N >= 4), else by the masked path.
    Raises ``ValueError`` on what the kernel refuses: an N outside
    ``SUPPORTED_N``, or an empty or too large shape."""
    _check_shape(B, T, D, N)
    tiles = _cdiv(D * N, BWD_COLS)
    per = _cdiv(tiles, min(tiles, BWD_MAX_PARTIALS))
    partials = _cdiv(tiles, per)
    rows, chunks = min(T, BWD_CHUNK), _cdiv(T, BWD_CHUNK)
    stage = (2 * rows * BWD_COLS + _cdiv(rows * (BWD_COLS // N), 32) * 32
             + _cdiv(rows * N, 32) * 32 + 2 * BWD_COLS)
    smem = 2 * 4 * stage + rows * N * 8 + 32
    return ScanBwdPlan(BWD_COLS, BWD_CHUNK, rows, chunks, tiles, per,
                       partials, D % 4 == 0 and N >= 4, smem,
                       (B, T, partials, N), (B, chunks - 1, D, N))


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


def selective_scan_bwd_plain(a, bx, c, h0, dy, dh_last):
    """Plain PyTorch reverse scan (the card's oracle for the backward):
    (da, dbx, dc, dh0) of the forward's inputs from dy (B, T, D) and
    dh_last (B, D, N).  The forward is recomputed into h (B, T + 1, D, N),
    in the inputs' dtype (float64 gives ``chip_smoke.py`` its oracle)."""
    B, T, D, N = a.shape
    h = torch.empty((B, T + 1, D, N), dtype=a.dtype, device=a.device)
    h[:, 0] = h0
    for t in range(T):
        h[:, t + 1] = a[:, t] * h[:, t] + bx[:, t]
    dc = (dy[..., None] * h[:, 1:]).sum(dim=2)
    da = torch.empty_like(h[:, 1:])
    dbx = torch.empty_like(da)
    carry = dh_last.to(a.dtype)
    for t in range(T - 1, -1, -1):
        g = carry + dy[:, t, :, None] * c[:, t, None, :]
        dbx[:, t] = g
        da[:, t] = g * h[:, t]
        carry = a[:, t] * g
    return da, dbx, dc, carry


def _check(tensors, B, T, D, N) -> None:
    for t, name, shape in tensors:
        if t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError(f"{name}: float32 CUDA tensor required, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
    _check_shape(B, T, D, N)


def _scan_cuda(a, bx, c, h0):
    B, T, D, N = a.shape
    _check(((a, "a", (B, T, D, N)), (bx, "bx", (B, T, D, N)),
            (c, "c", (B, T, N)), (h0, "h0", (B, D, N))), B, T, D, N)
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


def selective_scan_bwd(a, bx, c, h0, dy, dh_last):
    """(da, dbx, dc, dh0) of the scan: the plain version for CPU tensors,
    the hand-written kernel for CUDA tensors.  ``dy`` and ``dh_last`` are
    made contiguous (autograd hands :class:`SelectiveScan` a zero
    ``dh_last`` when ``h_last`` is unused)."""
    if a.device.type == "cpu":
        return selective_scan_bwd_plain(a, bx, c, h0, dy, dh_last)
    B, T, D, N = a.shape
    dy, dh_last = dy.contiguous(), dh_last.contiguous()
    _check(((a, "a", (B, T, D, N)), (bx, "bx", (B, T, D, N)),
            (c, "c", (B, T, N)), (h0, "h0", (B, D, N)),
            (dy, "dy", (B, T, D)), (dh_last, "dh_last", (B, D, N))),
           B, T, D, N)
    plan = scan_bwd_plan(B, T, D, N)
    lib = build.load("selective_scan_bwd")
    da = torch.empty_like(a)
    dbx = torch.empty_like(a)
    dc = torch.empty((B, T, N), dtype=torch.float32, device=a.device)
    dh0 = torch.empty_like(h0)
    part = torch.empty(plan.part_shape, dtype=torch.float64, device=a.device)
    ckpt = torch.empty(plan.ckpt_shape, dtype=torch.float32,
                       device=a.device) if plan.chunks > 1 else None
    bulk = plan.bulk and all(t.data_ptr() % 16 == 0
                             for t in (a, bx, c, h0, dy, dh_last))
    err = lib.selective_scan_bwd_f32(
        a.data_ptr(), bx.data_ptr(), c.data_ptr(), h0.data_ptr(),
        dy.data_ptr(), dh_last.data_ptr(), da.data_ptr(), dbx.data_ptr(),
        dc.data_ptr(), dh0.data_ptr(), part.data_ptr(),
        None if ckpt is None else ckpt.data_ptr(), B, T, D, N, plan.cols,
        plan.chunk, plan.per, plan.partials, plan.smem_bytes, int(bulk),
        build.stream_of(a))
    build.check(err, "selective_scan_bwd")
    build.LAUNCHES["selective_scan_bwd"] += 1
    return da, dbx, dc, dh0


class SelectiveScan(torch.autograd.Function):
    """The scan kernel with the reverse-scan kernel as its backward.  Saves
    the four inputs; the backward recomputes h rather than keep the
    (B, T, D, N) states of the forward."""

    @staticmethod
    def forward(ctx, a, bx, c, h0):
        ctx.save_for_backward(a, bx, c, h0)
        return _scan_cuda(a, bx, c, h0)

    @staticmethod
    def backward(ctx, dy, dh_last):
        return selective_scan_bwd(*ctx.saved_tensors, dy, dh_last)


def selective_scan(a, bx, c, h0):
    if a.device.type == "cpu":
        return selective_scan_plain(a, bx, c, h0)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (a, bx, c, h0)):
        return SelectiveScan.apply(a, bx, c, h0)
    return _scan_cuda(a, bx, c, h0)
