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

Types.  x, W and y are float32 or bfloat16 (both the same); u, v and s are
float32, as the reference's operands are.  In bf16 the arithmetic is the
Pallas kernel's: x W and x·u accumulate in float32 (``f32(x)·u``), the
epilogue adds s (x·u) v in float32, and the sum is cast to bf16 once.  The
plain versions follow that arithmetic, so on float32 inputs they are what
they always were.

Bound on the H100: the float32 FMA rate of the CUDA cores (67 TFLOP/s); at
the main paths' shapes a product does 40 to 130 flops per byte it must
move.  No TF32: the ZO coefficient (L+ − L−) / 2ε amplifies its ~3-digit
error.  All three run one kernel, ``rank1_gemm`` (the plain product is the
expert product with E = 1; the transposed product is a template flag that
copies W's rows along K, as x's are, and stores them [n][k]): an
88 × 128 output tile per 128-thread block, 11 × 8 float32 accumulators
per thread, slabs of 16 k streamed through a 4-stage ``cp.async`` ring in
shared memory, and the rank-1 dot (x·u, or x·v for ``rank1_matmul_t``)
spread over the whole block on the same slabs, so W is read once per
output tile.  Where the output tiles are too few to fill the card,
:func:`split_plan` cuts K into ranges whose partial sums a second kernel
adds in a fixed order (no atomics: the same inputs give the same bits).
W may be a strided view of the stacked parameters (its client and expert
strides are passed to the kernel); the inner (K, N) / (O, K) matrix must be
contiguous.

The bf16 path is a second kernel in the same file, ``rank1_gemm_bf16``: a
persistent, warp-specialised ``wgmma`` product (128 × 256 output tiles,
two consumer warpgroups, a producer that fills a 4-stage ring of 64-k slabs
by TMA; its geometry is ``TILE16``), with x·u computed once per row before
it, the same split-K and strides.  Where the row tiles are many or even,
two CTAs on neighbouring row tiles form a cluster and share each W slab by
TMA multicast (:func:`cluster_of`).  When the clients share one W (a client
stride of 0) and x is contiguous over (C, M), their rows are folded into
one product of C·M rows (:func:`folds`), so W is streamed about once.  It
takes K % 8 == 0 and 16-byte-aligned operands (it raises on the rest), and
pads W's rows to a multiple of 8 first where N is not one (InternVL's
92,553 logits).  Its launches count under the op's name with ``_bf16``
appended.

Each wrapper runs its plain PyTorch version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build

#: output tile (rows, columns) and k-slab of ``rank1_gemm`` in the .cu file
TILE_M, TILE_N, TILE_K = 88, 128, 16
#: streaming multiprocessors of an H100 SXM, and the blocks of ``rank1_gemm``
#: one holds at a time (its registers allow two)
SMS, BLOCKS_PER_SM = 132, 2
SLOTS = SMS * BLOCKS_PER_SM
#: the split plan's clock, from the kernel's times on an H100 SXM at 700 W:
#: one slab of one block beside another on its SM, and alone; a wave's
#: fill and drain; the rate at which partial sums are written and re-read
T_SLAB_US, T_ALONE_US, T_WAVE_US, PARTIAL_BYTES_PER_US = 2.32, 1.55, 12.0, 2.5e6
MAX_SPLITS = 64
#: the bf16 kernel's tile and k-slab, its blocks per SM (one, persistent),
#: and its clock (the same quantities as above; one block an SM, so a slab
#: takes as long alone: 0.78 us at InternVL2-26B's pod shapes, epilogue
#: included, on an H100 SXM at 700 W)
TILE16 = (128, 256, 64)
BLOCKS_PER_SM16 = 1
T_SLAB16_US = T_ALONE16_US = 0.78
#: cluster row tiles of a band of the bf16 kernel's raster (``tile_of``)
RASTER_ROWS = 8
#: CUDA's limit on a grid's y and z extents
GRID_YZ = 65535


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def split_plan(batch: int, M: int, N: int, K: int, *,
               bf16: bool = False) -> tuple[int, int]:
    """(splits, k per split) of ``rank1_gemm`` (``rank1_gemm_bf16`` when
    ``bf16``) for ``batch`` products (clients, or clients × experts) of
    x (M, K) by W (K, N).

    A pure function of the shape.  Output tiles that fill two waves of the
    card's block slots take one split.  Fewer are cut into ranges of whole
    k-slabs, as many as the clock above says run fastest, the partial
    sums' traffic counted: every split is non-empty and together they cover
    K exactly."""
    if bf16:
        (tm, tn, tk), slots = TILE16, SMS * BLOCKS_PER_SM16
        t_slab, t_alone = T_SLAB16_US, T_ALONE16_US
    else:
        tm, tn, tk, slots = TILE_M, TILE_N, TILE_K, SLOTS
        t_slab, t_alone = T_SLAB_US, T_ALONE_US
    tiles = batch * _cdiv(M, tm) * _cdiv(N, tn)
    slabs = _cdiv(K, tk)
    if tiles >= 2 * slots:
        return 1, slabs * tk
    best = None
    for want in range(1, min(slabs, MAX_SPLITS) + 1):
        per = _cdiv(slabs, want)
        splits = _cdiv(slabs, per)
        full, rest = divmod(tiles * splits, slots)
        us = full * (per * t_slab + T_WAVE_US)
        if rest:
            us += per * (t_alone if rest <= SMS else t_slab) + T_WAVE_US
        if splits > 1:
            us += (2 * splits + 1) * 4 * batch * M * N / PARTIAL_BYTES_PER_US
        if best is None or us < best[0]:
            best = (us, splits, per)
    return best[1], best[2] * tk


def folds(C: int, E: int, M: int, K: int, sx_c: int, sw_c: int) -> bool:
    """Whether the bf16 kernel folds the C clients' rows into one product of
    C·M rows: one W for all (a client stride of 0), no experts, x
    contiguous over (C, M) (y, which the wrapper allocates, always is)."""
    return C > 1 and E == 1 and sw_c == 0 and sx_c == M * K


def gemm_plan(C: int, E: int, M: int, N: int, K: int, *, bf16: bool = False,
              fold: bool = False) -> tuple[int, int]:
    """(splits, k per split) of the launch for C clients × E experts of
    x (M, K) by W (K, N): :func:`split_plan` of C·E products, or of one
    product of C·M rows when the bf16 kernel folds them (``fold``)."""
    if bf16 and fold:
        return split_plan(1, C * M, N, K, bf16=True)
    return split_plan(C * E, M, N, K, bf16=bf16)


def cluster_of(rows: int) -> int:
    """CTAs of a cluster of the bf16 kernel for products of ``rows`` rows:
    two (neighbouring row tiles, W's slabs read once for both and
    multicast) unless the row tiles are few and odd, where the pair's
    empty half would cost more than the shared W saves (the Jamba cut's
    330-row experts, Qwen's 2112 folded rows: 3 and 17 row tiles)."""
    tiles = _cdiv(rows, TILE16[0])
    return 2 if tiles % 2 == 0 or tiles >= 32 else 1


def tile_of(t: int, S: int, rt: int, ct: int, group: int = RASTER_ROWS):
    """(product, split, row tile, column tile) of the bf16 kernel's cluster
    tile ``t`` (``rt`` row tiles of ``cluster_of`` × 128 rows), as
    ``tile_of`` in the .cu computes it: products and splits outermost,
    then bands of ``group`` row tiles walked column tile by column
    tile."""
    bs, r = divmod(t, rt * ct)
    b, split = divmod(bs, S)
    band = group * ct
    first = r // band * group
    rows = min(group, rt - first)
    w = r % band
    return b, split, first + w % rows, w // rows


def to_f32(t):
    """float32 of ``t`` (no copy when it is float32); a leading axis of
    stride 0 (one model seen by every client) stays a view of one copy."""
    if t.dtype == torch.float32:
        return t
    if t.stride(0) == 0:
        return t[:1].float().expand(t.shape)
    return t.float()


def rank1_matmul_plain(x, W, u, v, s):
    """Plain PyTorch rank1_matmul (the CPU path and the card's oracle):
    float32 products and epilogue, cast once to x's type."""
    xf = to_f32(x)
    y = torch.bmm(xf, to_f32(W))
    xu = torch.bmm(xf, u.unsqueeze(-1))                    # (C, M, 1)
    return (y + (s[:, None, None] * xu) * v[:, None, :]).to(x.dtype)


def rank1_matmul_t_plain(x, W, u, v, s):
    """Plain PyTorch rank1_matmul_t (the CPU path and the card's oracle)."""
    xf = to_f32(x)
    y = torch.bmm(xf, to_f32(W).transpose(1, 2))
    xv = torch.bmm(xf, v.unsqueeze(-1))                    # (C, M, 1)
    return (y + (s[:, None, None] * xv) * u[:, None, :]).to(x.dtype)


def rank1_matmul_expert_plain(x, W, u, v, s):
    """Plain PyTorch rank1_matmul_expert (the CPU path and the card's oracle)."""
    xf = to_f32(x)
    y = torch.matmul(xf, to_f32(W))
    xu = torch.matmul(xf, u.unsqueeze(-1))                 # (C, E, M, 1)
    return (y + (s[:, None, None, None] * xu)
            * v[:, :, None, :]).to(x.dtype)


#: the types x, W and y may take
DTYPES = (torch.float32, torch.bfloat16)


def _check_types(x, W, u, v, s):
    """x and W float32 or bf16 (the same), u, v and s float32, all on the
    card."""
    for name, t in (("x", x), ("W", W), ("u", u), ("v", v), ("s", s)):
        if not t.is_cuda:
            raise ValueError(f"{name}: CUDA tensor required, got {t.device}")
    if x.dtype not in DTYPES or W.dtype != x.dtype:
        raise ValueError(f"x and W: float32 or bfloat16, the same, got "
                         f"{x.dtype} and {W.dtype}")
    for name, t in (("u", u), ("v", v), ("s", s)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: float32 required, got {t.dtype}")


def _check_inner(x, W, u, v, s):
    """Contiguity the kernels need: x's and W's inner matrices, u's and v's
    last axis, s."""
    for t, name in ((x, "x"), (W, "W")):
        if t.stride(-1) != 1 or t.stride(-2) != t.shape[-1]:
            raise ValueError(f"{name}: inner matrix must be contiguous")
    if u.stride(-1) != 1 or v.stride(-1) != 1 or s.stride(0) != 1:
        raise ValueError("u/v/s must be contiguous along their last axis")


def _gemm(name, x, W, u, v, s, y, E, strides, trans=False):
    """Launch ``rank1_matmul_f32`` (``rank1_matmul_bf16`` for bf16 x and W)
    for x (C, [E,] M, K) and W (C, [E,] K, N), or W (C, O, K) read
    transposed (``trans``), into y (C, [E,] M, N); ``strides`` are the
    client and expert strides of x, W, u (the contracted vector), v (the
    output vector) and y (an expert stride of 0 for the dense products)."""
    C, M, K, N = x.shape[0], x.shape[-2], x.shape[-1], y.shape[-1]
    if x.dtype == torch.bfloat16:
        return _gemm16(name, x, W, u, v, s, y, E, strides, trans)
    splits, kper = split_plan(C * E, M, N, K)
    if _cdiv(N, TILE_N) > GRID_YZ or C * E * splits > GRID_YZ:
        raise ValueError("grid too large")
    lib = build.load("rank1_matmul")
    # partial tiles, then partial x·u, of every split (freed in stream order)
    part = None if splits == 1 else torch.empty(
        splits * C * E * M * (N + 1), dtype=torch.float32, device=x.device)
    err = lib.rank1_matmul_f32(
        x.data_ptr(), W.data_ptr(), u.data_ptr(), v.data_ptr(), s.data_ptr(),
        y.data_ptr(), None if part is None else part.data_ptr(), C, E, M, N,
        K, splits, kper, int(trans), *strides, build.stream_of(x))
    build.check(err, name)
    build.LAUNCHES[name] += 1
    return y


def _gemm16(name, x, W, u, v, s, y, E, strides, trans):
    """The bf16 launch of :func:`_gemm`."""
    C, M, K, N = x.shape[0], x.shape[-2], x.shape[-1], y.shape[-1]
    if K % 8 or (x.data_ptr() | W.data_ptr()) % 16 \
            or any(t % 8 for t in strides[:4]):
        raise ValueError(f"{name}: the bf16 kernel takes K % 8 == 0 and "
                         f"16-byte-aligned x and W (K {K}, strides "
                         f"{strides[:4]})")
    fold = folds(C, E, M, K, strides[0], strides[2])
    splits, kper = gemm_plan(C, E, M, N, K, bf16=True, fold=fold)
    cluster = cluster_of(C * M if fold else M)
    lib = build.load("rank1_matmul")
    dev = x.device
    # x·u of every row, and the splits' partial tiles (freed in stream
    # order)
    xu = torch.empty(C * E * M, dtype=torch.float32, device=dev)
    part = None if splits == 1 else torch.empty(
        splits * C * E * M * N, dtype=torch.float32, device=dev)
    # W (K, N) with N % 8 != 0: rows padded into a copy of each distinct W
    # (one, when the clients share it with a stride of 0)
    pad = None
    if not trans and N % 8:
        copies = (1 if strides[2] == 0 else C) * E
        pad = torch.empty(copies * K * (_cdiv(N, 8) * 8),
                          dtype=torch.bfloat16, device=dev)
    err = lib.rank1_matmul_bf16(
        x.data_ptr(), W.data_ptr(), u.data_ptr(), v.data_ptr(), s.data_ptr(),
        y.data_ptr(), None if part is None else part.data_ptr(),
        None if pad is None else pad.data_ptr(), xu.data_ptr(), C, E, M, N,
        K, splits, kper, int(trans), int(fold), cluster, RASTER_ROWS,
        SMS * BLOCKS_PER_SM16, *strides, build.stream_of(x))
    name += "_bf16"
    build.check(err, name)
    build.LAUNCHES[name] += 1
    return y


def rank1_matmul(x, W, u, v, s):
    if x.device.type == "cpu":
        return rank1_matmul_plain(x, W, u, v, s)
    C, M, K = x.shape
    N = W.shape[-1]
    if tuple(W.shape) != (C, K, N):
        raise ValueError(f"W shape {tuple(W.shape)} != {(C, K, N)}")
    _check_types(x, W, u, v, s)
    if u.shape != (C, K) or v.shape != (C, N) or s.shape != (C,):
        raise ValueError("u/v/s shapes do not match x and W")
    _check_inner(x, W, u, v, s)
    y = torch.empty((C, M, N), dtype=x.dtype, device=x.device)
    return _gemm("rank1_matmul", x, W, u, v, s, y, 1,
                 (x.stride(0), 0, W.stride(0), 0, u.stride(0), 0, v.stride(0),
                  0, M * N, 0))


def rank1_matmul_t(x, W, u, v, s):
    if x.device.type == "cpu":
        return rank1_matmul_t_plain(x, W, u, v, s)
    C, M, K = x.shape
    O = W.shape[-2]
    if tuple(W.shape) != (C, O, K):
        raise ValueError(f"W shape {tuple(W.shape)} != {(C, O, K)}")
    _check_types(x, W, u, v, s)
    if u.shape != (C, O) or v.shape != (C, K) or s.shape != (C,):
        raise ValueError("u/v/s shapes do not match x and W")
    _check_inner(x, W, u, v, s)
    y = torch.empty((C, M, O), dtype=x.dtype, device=x.device)
    # the contracted vector is v (K), the output vector u (O)
    return _gemm("rank1_matmul_t", x, W, v, u, s, y, 1,
                 (x.stride(0), 0, W.stride(0), 0, v.stride(0), 0, u.stride(0),
                  0, M * O, 0), trans=True)


def rank1_matmul_expert(x, W, u, v, s):
    if x.device.type == "cpu":
        return rank1_matmul_expert_plain(x, W, u, v, s)
    C, E, M, K = x.shape
    N = W.shape[-1]
    _check_types(x, W, u, v, s)
    if tuple(W.shape) != (C, E, K, N) or u.shape != (C, E, K) \
            or v.shape != (C, E, N) or s.shape != (C,):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, W "
                         f"{tuple(W.shape)}, u {tuple(u.shape)}, v "
                         f"{tuple(v.shape)}, s {tuple(s.shape)}")
    _check_inner(x, W, u, v, s)
    y = torch.empty((C, E, M, N), dtype=x.dtype, device=x.device)
    return _gemm("rank1_matmul_expert", x, W, u, v, s, y, E,
                 (*x.stride()[:2], *W.stride()[:2], *u.stride()[:2],
                  *v.stride()[:2], E * M * N, M * N))
