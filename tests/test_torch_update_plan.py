"""The geometry of the SubCGE update kernel, ``subcge_apply.update_plan`` (CPU).

The kernel walks a persistent grid over (instance, column chunk, row tile);
``update_plan`` decides the chunk width, the tile height, the tiles of each
block and the shared memory; ``plan_tiles`` below is the kernel's tile map
in Python.  Here the plan is held, for every matrix leaf of the main paths'
updates (Qwen1.5-0.5B, the Kimi K2 cut, the Falcon Mamba 7B cut at 8
clients; OPT-125M at 64 clients, the paper's 8 x 8 mesh-grid) and for
ragged shapes, to cover every element exactly once, and to refuse what the
kernel refuses.

The same for the tensor-core kernel's geometry, ``subcge_apply.stream_plan``
(bf16 W at any rank, float32 W past rank 32), with the bf16 pod's leaves
(one InternVL2-26B, one Qwen1.5-0.5B); the k walk of its A V^T groups and
epochs; the 16-byte pieces of its flat path; and the arithmetic of its
TF32 split (``tc_update``: the kernel's delta in plain PyTorch, the error
model that sets the split).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import archs  # noqa: E402
from repro_torch.core.subcge import update_shapes  # noqa: E402
from repro_torch.kernels import subcge_apply as sa  # noqa: E402
from repro_torch.models.params import subcge_meta  # noqa: E402
from repro_torch.models.transformer import arch_spec  # noqa: E402

C, RANK = 8, 16
#: clients of the paper-setting path (OPT-125M on the 8 x 8 mesh-grid)
C_PAPER = 64
#: shared memory of one SM, and what CUDA reserves per block
SM_SMEM, BLOCK_RESERVED = 228 * 1024, 1024


def _leaves(arch, clients=C):
    """(instances, n, m) of every matrix leaf one update of the stacked
    params of ``clients`` clients visits."""
    return {(math.prod(b), n, m) for b, n, m, _ in
            update_shapes(subcge_meta(arch_spec(arch)), clients)}


def _main_path_leaves():
    """The leaves of the main paths' updates, with the Kimi and Falcon cuts
    that ``chip_smoke.py`` trains, and OPT-125M at 64 clients."""
    return sorted(_leaves(archs.get("qwen1.5-0.5b")) | _leaves(archs.kimi_cut())
                  | _leaves(archs.falcon_cut())
                  | _leaves(archs.get("opt-125m"), C_PAPER))


LEAVES = _main_path_leaves()


def plan_tiles(plan: sa.UpdatePlan, nb: int, n: int, m: int):
    """Yield (block, instance, row range, column range) of every tile the
    launch visits, in order: the block-to-tile map of ``subcge_stream_kernel``
    (``csrc/subcge_apply.cu``) in Python."""
    total = nb * plan.chunks * plan.tiles
    for k in range(plan.blocks):
        for g in range(k * plan.per, min((k + 1) * plan.per, total)):
            bq, t = divmod(g, plan.tiles)
            b, chunk = divmod(bq, plan.chunks)
            r0, c0 = t * plan.tile_rows, chunk * plan.bc
            yield (k, b, (r0, min(r0 + plan.tile_rows, n)),
                   (c0, min(c0 + plan.bc, m)))


def test_leaves_are_the_published_ones():
    """Spot-check: Qwen's tied embedding, a Kimi expert stack, and Falcon's
    narrow conv_w (m = 4), A_log (m = 16) and x_proj (m = 288)."""
    assert (8, 151936, 1024) in LEAVES
    assert (256, 7168, 2048) in LEAVES
    for m in (4, 16, 288):
        assert (32, 8192, m) in LEAVES
    # OPT-125M at 64 clients: the tied embedding (2.47e9 elements, past
    # 2^31), the learned positions and the 12 stacked layers' projections
    for leaf in ((64, 50272, 768), (64, 4096, 768), (768, 768, 768),
                 (768, 768, 3072), (768, 3072, 768)):
        assert leaf in LEAVES


def test_update_shapes_cover_every_matrix_param():
    """``update_shapes`` merges leaves of one shape and misses none: its
    entries hold every element of the stacked matrix leaves."""
    for arch in (archs.get("qwen1.5-0.5b"), archs.kimi_cut(),
                 archs.falcon_cut()):
        spec = arch_spec(arch)
        want = C * sum(math.prod(s.shape) for s in spec.values()
                       if len(s.shape) - s.n_batch_dims == 2)
        got = update_shapes(subcge_meta(spec), C)
        assert sum(math.prod(b) * n * m * k for b, n, m, k in got) == want
        assert len({(b, n, m) for b, n, m, _ in got}) == len(got)
    assert ((8, 24), 1024, 1024, 4) in update_shapes(
        subcge_meta(arch_spec(archs.get("qwen1.5-0.5b"))), C)


def test_cuts_keep_the_published_widths():
    kimi, falcon = archs.kimi_cut(), archs.falcon_cut()
    slot = kimi.groups[0].slots[0]
    assert (kimi.d_model, slot.attn.n_heads, slot.moe.d_ff_expert) == \
        (7168, 64, 2048)
    assert (slot.moe.n_experts, kimi.vocab, kimi.groups[0].reps) == \
        (archs.KIMI_EXPERTS, archs.KIMI_VOCAB, archs.KIMI_LAYERS)
    mamba = falcon.groups[0].slots[0].mamba
    assert (falcon.d_model, mamba.d_inner, mamba.d_state, falcon.vocab) == \
        (4096, 8192, 16, 65_024)
    assert falcon.groups[0].reps == archs.FALCON_LAYERS


def plan_tile_arrays(plan: sa.UpdatePlan, nb: int, n: int, m: int):
    """``plan_tiles`` as arrays over every tile at once (the main paths'
    leaves have up to ~10^6 tiles): block, instance, row range, column
    range, in launch order."""
    total = nb * plan.chunks * plan.tiles
    g = np.concatenate([np.arange(k * plan.per, min((k + 1) * plan.per, total))
                        for k in range(plan.blocks)])
    k = g // plan.per
    bq, t = np.divmod(g, plan.tiles)
    b, chunk = np.divmod(bq, plan.chunks)
    r0, c0 = t * plan.tile_rows, chunk * plan.bc
    return (k, b, (r0, np.minimum(r0 + plan.tile_rows, n)),
            (c0, np.minimum(c0 + plan.bc, m)))


def test_tile_arrays_are_the_tile_map():
    plan = sa.update_plan(5, 517, 288, RANK, 1)
    k, b, (r0, r1), (c0, c1) = plan_tile_arrays(plan, 5, 517, 288)
    assert list(zip(k, b, zip(r0, r1), zip(c0, c1))) == \
        list(plan_tiles(plan, 5, 517, 288))


def _tile_counts(plan, nb, n, m):
    """How often each (instance, row tile, chunk) is visited; and that each
    tile's ranges are the plan's grid cells."""
    _, b, (r0, r1), (c0, c1) = plan_tile_arrays(plan, nb, n, m)
    assert (r0 % plan.tile_rows == 0).all() and (c0 % plan.bc == 0).all()
    assert (r1 == np.minimum(r0 + plan.tile_rows, n)).all()
    assert (c1 == np.minimum(c0 + plan.bc, m)).all()
    seen = np.zeros((nb, plan.tiles, plan.chunks), np.int64)
    np.add.at(seen, (b, r0 // plan.tile_rows, c0 // plan.bc), 1)
    return seen


@pytest.mark.parametrize("leaf", LEAVES, ids=lambda a: "x".join(map(str, a)))
def test_main_path_leaves_are_covered_once(leaf):
    """Every tile of every instance exactly once, the tiles cover (n, m),
    and no block is empty or past the persistent grid's slots."""
    nb, n, m = leaf
    plan = sa.update_plan(nb, n, m, RANK, 1)
    assert plan.tiles * plan.tile_rows >= n > (plan.tiles - 1) * plan.tile_rows
    assert plan.chunks * plan.bc >= m > (plan.chunks - 1) * plan.bc
    assert (_tile_counts(plan, nb, n, m) == 1).all()
    assert plan.blocks <= sa.SLOTS
    assert (plan.blocks - 1) * plan.per < nb * plan.chunks * plan.tiles


@pytest.mark.parametrize("shape", [(1, 1, 1, 1, 1), (3, 70, 150, 16, 2),
                                   (2, 65, 33, 32, 4), (5, 517, 288, 16, 1),
                                   (4, 300, 5, 7, 3), (2, 200, 130, 32, 5),
                                   (600, 3, 9, 2, 1)],
                         ids=lambda a: "x".join(map(str, a)))
def test_ragged_shapes_cover_every_element_once(shape):
    """Ragged n and m (m % 4 != 0, m < 128), r off 4, E > G, more
    (instance, chunk, tile) cells than blocks: each element exactly once."""
    nb, n, m, r, E = shape
    plan = sa.update_plan(nb, n, m, r, E)
    seen = np.zeros((nb, n, m), np.int64)
    for _, b, (r0, r1), (c0, c1) in plan_tiles(plan, nb, n, m):
        seen[b, r0:r1, c0:c1] += 1
    assert (seen == 1).all()
    assert 1 <= plan.groups <= E
    assert plan.groups * r * plan.bc <= max(sa.AV_FLOATS, r * plan.bc)


@pytest.mark.parametrize("m,bc", [(4, 4), (16, 16), (32, 32), (288, 64),
                                  (1024, 128), (2816, 128), (5, 8),
                                  (150, 32)])
def test_chunk_width_fits_narrow_leaves(m, bc):
    """The chunk width pads m by at most 1/8 over the least padding: the
    narrow leaves (Falcon's conv_w, A_log and x_proj, the Kimi router) get
    chunks of their own width, the wide ones 128 columns."""
    plan = sa.update_plan(8, 100, m, RANK, 1)
    assert plan.bc == bc
    assert plan.tile_rows == sa.THREADS // 32 * sa.ROWS_PER_THREAD * 128 // bc


@pytest.mark.parametrize("r,E", [(16, 1), (16, 2), (16, 4), (32, 2),
                                 (32, 8), (1, 1)])
def test_shared_memory_fits(r, E):
    """The ring, A V^T and the staging fit one block's shared memory; up to
    E = 4 at r = 16 (the main paths' rank), and E = 1 at r = 32, the three
    blocks per SM of the persistent grid still fit."""
    plan = sa.update_plan(8, 4096, 1024, r, E)
    assert plan.smem_bytes <= 227 * 1024
    if (r <= 16 and E * r <= 64) or E == 1:
        assert sa.SLOTS // 132 * (plan.smem_bytes + BLOCK_RESERVED) <= SM_SMEM


@pytest.mark.parametrize("args", [(8, 64, 64, 0, 1), (8, 64, 64, 33, 1),
                                  (0, 64, 64, 16, 1), (8, 0, 64, 16, 1),
                                  (8, 64, 0, 16, 1), (8, 64, 64, 16, 0)],
                         ids=["r0", "r33", "nb0", "n0", "m0", "E0"])
def test_plan_refuses_what_the_kernel_refuses(args):
    with pytest.raises(ValueError):
        sa.update_plan(*args)


def test_plan_is_pure():
    a = sa.update_plan(192, 1024, 2816, RANK, 1)
    assert sa.update_plan(192, 1024, 2816, RANK, 1) == a
    assert sa.update_plan.__wrapped__(192, 1024, 2816, RANK, 1) == a


# -- update_tc_kernel: its plan, its k walk, its flat path, its arithmetic

#: the main paths' leaves, and those of the bf16 pod (one model a launch)
TC_LEAVES = sorted(set(LEAVES) | _leaves(archs.get("internvl2-26b"), 1)
                   | _leaves(archs.get("qwen1.5-0.5b"), 1))


def stream_tile_arrays(plan: sa.StreamPlan, nb: int, n: int, m: int):
    """Block, instance, row tile and column chunk of every tile of a
    ``subcge_update_tc_*`` launch, in launch order (``tc::tile_of``: per
    instance, super-chunks of ``plan.sub`` chunks, row tile by row tile,
    the row tile's chunks of the super-chunk side by side)."""
    total = nb * plan.chunks * plan.tiles
    g = np.concatenate([np.arange(k * plan.per, min((k + 1) * plan.per, total))
                        for k in range(plan.blocks)])
    b, u = np.divmod(g, plan.chunks * plan.tiles)
    sc, v = np.divmod(u, plan.sub * plan.tiles)
    ns = np.minimum(plan.sub, plan.chunks - sc * plan.sub)
    return g // plan.per, b, v // ns, sc * plan.sub + v % ns


def k_walk(plan: sa.StreamPlan, r: int):
    """(group, epoch, first p, rows) of each epoch's share of each A V^T
    group, as ``tc::build_av`` walks them, and the k8 steps of each group
    (``tc::load_u``)."""
    shares, steps = [], []
    for grp in range(plan.groups):
        kg0 = grp * plan.kgroup
        kl = min(plan.kgroup, plan.k - kg0)
        e = kg0 // plan.rp
        while e * plan.rp < kg0 + kl:
            k_lo = max(kg0, e * plan.rp)
            ne = min(kg0 + kl, (e + 1) * plan.rp) - k_lo
            shares.append((grp, e, k_lo - e * plan.rp, ne))
            e += 1
        steps.append(range(0, kl, 8))
    return shares, steps


@pytest.mark.parametrize("esz", [2, 4])
@pytest.mark.parametrize("leaf", TC_LEAVES, ids=lambda a: "x".join(map(str, a)))
def test_stream_plan_covers_main_path_leaves_once(leaf, esz):
    """Every 128 x 64 tile of every instance exactly once, the tiles cover
    (n, m), no block is empty or past the 132 SMs; a super-chunk holds 4
    chunks at k = 16 (2 at k = 64, 1 at 128) and its A V^T fits the
    kernel's 32 KB of hi (and of lo)."""
    nb, n, m = leaf
    plan = sa.stream_plan(nb, n, m, 16, 1, esz)
    assert plan.tiles * sa.TC_ROWS >= n > (plan.tiles - 1) * sa.TC_ROWS
    assert plan.chunks * sa.TC_COLS >= m > (plan.chunks - 1) * sa.TC_COLS
    _, b, t, chunk = stream_tile_arrays(plan, nb, n, m)
    seen = np.zeros((nb, plan.tiles, plan.chunks), np.int64)
    np.add.at(seen, (b, t, chunk), 1)
    assert (seen == 1).all()
    assert plan.blocks <= sa.TC_SLOTS
    assert (plan.blocks - 1) * plan.per < nb * plan.chunks * plan.tiles
    for r, sub in ((16, 4), (64, 2), (128, 1)):
        plan = sa.stream_plan(nb, n, m, r, 1, esz)
        assert plan.sub == sub
        assert plan.sub * -(-plan.kgroup // 32) * sa.TC_KB_BYTES \
            <= sa.TC_KMAX // 32 * sa.TC_KB_BYTES


@pytest.mark.parametrize("shape", [(1, 1, 1, 1, 1), (3, 300, 200, 33, 2),
                                   (2, 129, 150, 64, 4), (1, 64, 92553, 16, 1),
                                   (4, 70, 92, 128, 2), (600, 3, 9, 2, 1),
                                   (2, 257, 1001, 16, 8), (1, 33, 65, 130, 1)],
                         ids=lambda a: "x".join(map(str, a)))
def test_stream_plan_ragged_shapes_cover_once(shape):
    """Ragged n and m, r off 8, k past 128 (several groups), more tiles
    than blocks: each element exactly once; each epoch's rows p < rp of A
    V^T formed once, in groups of at most ``TC_KMAX`` whole k8 steps."""
    nb, n, m, r, E = shape
    plan = sa.stream_plan(nb, n, m, r, E, 2)
    seen = np.zeros((nb, n, m), np.int64)
    _, b, t, chunk = stream_tile_arrays(plan, nb, n, m)
    for bi, ti, ci in zip(b, t, chunk):
        seen[bi, ti * sa.TC_ROWS:(ti + 1) * sa.TC_ROWS,
             ci * sa.TC_COLS:(ci + 1) * sa.TC_COLS] += 1
    assert (seen == 1).all()
    assert plan.rp % 8 == 0 and plan.rp - 8 < r <= plan.rp
    assert plan.k == E * plan.rp and plan.kgroup % 8 == 0
    assert plan.kgroup <= sa.TC_KMAX
    assert (plan.groups - 1) * plan.kgroup < plan.k <= plan.groups * plan.kgroup
    shares, steps = k_walk(plan, r)
    rows = np.zeros((E, plan.rp), np.int64)
    for _, e, p0, ne in shares:
        rows[e, p0:p0 + ne] += 1
    assert (rows == 1).all()
    assert sum(len(s) for s in steps) * 8 == plan.k


@pytest.mark.parametrize("esz", [2, 4])
def test_stream_plan_shared_memory_fits(esz):
    """The ring, A V^T (hi and lo at k = 128) and the staging fit one
    block's 227 KB at every (E, r) the plan accepts (its size does not
    depend on them), with at least 32 KB of W in flight beyond the stage
    the consumers hold and the one the producer stores; and the plan
    accepts every (E, r)."""
    smem = sa.tc_smem_bytes(esz)
    assert smem + 2 * 8 * sa.TC_STAGES[esz] <= 227 * 1024
    assert (sa.TC_STAGES[esz] - 2) * sa.TC_ROWS * sa.TC_COLS * esz >= 32768
    for E in (1, 2, 3, 4, 8, 16):
        for r in (1, 8, 16, 31, 33, 64, 100, 128, 256):
            plan = sa.stream_plan(8, 4096, 1024, r, E, esz)
            assert plan.smem_bytes == smem
            assert plan.stages == sa.TC_STAGES[esz]
            assert plan.sub * -(-plan.kgroup // 32) <= sa.TC_KMAX // 32


@pytest.mark.parametrize("args", [(8, 64, 64, 0, 1, 2), (0, 64, 64, 16, 1, 2),
                                  (8, 0, 64, 16, 1, 2), (8, 64, 0, 16, 1, 2),
                                  (8, 64, 64, 16, 0, 2), (8, 64, 64, 16, 1, 8)],
                         ids=["r0", "nb0", "n0", "m0", "E0", "esz8"])
def test_stream_plan_refuses_what_the_kernel_refuses(args):
    with pytest.raises(ValueError):
        sa.stream_plan(*args)


def test_stream_plan_is_pure_and_picks_the_kernel():
    a = sa.stream_plan(48, 6144, 6144, 16, 1, 2)
    assert sa.stream_plan(48, 6144, 6144, 16, 1, 2) == a
    assert sa.stream_plan.__wrapped__(48, 6144, 6144, 16, 1, 2) == a
    assert sa.uses_tensor_cores(True, 1) and sa.uses_tensor_cores(False, 33)
    assert not sa.uses_tensor_cores(False, sa.MAX_RANK)


def flat_row_writes(shift: int, live: int, esz: int):
    """The bytes of one tile row that ``update_tc_kernel``'s flat path reads
    and writes, relative to the row's first element, which lies ``shift``
    bytes into its 16-byte piece: the pieces the producer copies, and the
    bytes the store writes (whole pieces inside the row, elements at its
    edges; out's shift taken equal)."""
    pieces = [j for j in range(sa.TC_COLS * esz // 16 + 1)
              if 16 * j < shift + live * esz]
    read = set()
    for j in pieces:
        read.update(range(16 * j - shift, 16 * j - shift + 16))
    written = []
    for j in range(sa.TC_COLS * esz // 16 + 1):
        lo, hi = 16 * j - shift, 16 * j - shift + 16
        if lo >= 0 and hi <= live * esz:
            written.extend(range(lo, hi))
        else:
            for x in range(max(lo, 0), min(hi, live * esz), esz):
                written.extend(range(x, x + esz))
    return read, written


@pytest.mark.parametrize("esz", [2, 4])
def test_flat_path_pieces_cover_each_row_once(esz):
    """At every shift of a row's first element in its 16-byte piece and
    every live width (m = 92,553's last chunk is 9 columns): the pieces
    read hold the row's elements and fit the stage's row pitch, and the
    store writes each element of the row once and nothing else."""
    for shift in range(0, 16, esz):
        for live in (1, 7, 9, 33, sa.TC_COLS - 1, sa.TC_COLS):
            read, written = flat_row_writes(shift, live, esz)
            assert set(range(live * esz)) <= read
            assert max(read) + shift < (sa.TC_COLS * esz // 16 + 1) * 16
            assert sorted(written) == list(range(live * esz))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties away
    from zero (half the weight of the 13 dropped bits added to the
    magnitude, then the bits cleared)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tc_update(W, U, A, V, split: bool = True):
    """``update_tc_kernel``'s arithmetic in plain PyTorch, for W (nb, n, m),
    U (E, n, r), A (E, nb, r, r), V (E, m, r): each epoch's r padded with
    zeros to rp (``stream_plan``), AV = blockdiag(A_e) [V_1 ... V_E]^T in
    float32, both operands split into TF32 hi and lo and the delta summed
    in float32 over k as hi.hi + hi.lo + lo.hi (one TF32 product, hi.hi
    alone, when not ``split``), added to f32(W) and cast to W's type."""
    E, n, r = U.shape
    nb, m = W.shape[0], V.shape[1]
    plan = sa.stream_plan(nb, n, m, r, E, W.element_size())
    pad = plan.rp - r
    Up = torch.nn.functional.pad(U, (0, pad)).permute(1, 0, 2)
    Up = Up.reshape(n, plan.k)
    AV = torch.einsum("ebpq,emq->bepm",
                      torch.nn.functional.pad(A, (0, pad, 0, pad)),
                      torch.nn.functional.pad(V, (0, pad)))
    AV = AV.reshape(nb, plan.k, m)
    uh, ah = tf32(Up), tf32(AV)
    delta = uh @ ah
    if split:
        delta = (tf32(Up - uh) @ ah + uh @ tf32(AV - ah)) + delta
    return (W.float() + delta).to(W.dtype)


@pytest.mark.parametrize("r", [16, 64, 128])
def test_tf32_split_holds_the_phase2_tolerance(r):
    """The error model of the split.  One TF32 operand is off by up to
    2^-11 of itself, so one TF32 product u av by ~2^-10: with the phase-2
    inputs (U, V standard normal, A at 1e-2, W at 0.05: |u av| ~ 1e-2
    r^1/2, |delta| ~ 1e-2 r) the delta is off by ~1e-5 r^1/2, past rtol /
    atol 1e-5 (float32) and past one bf16 ulp + 1e-5 of results near
    1e-3 (measured: 29, 73 and 135 times the float32 tolerance at r = 16,
    64 and 128).  Split in three, the dropped lo.lo and lo's own rounding
    leave ~2^-21 of each term, and the float32 sums over k dominate: each
    element lies within a quarter of both tolerances of the float64
    update (measured: 0.011, 0.042 and 0.126 of the float32 one, as close
    as the plain version's own float32 sums, 0.012, 0.048 and 0.108)."""
    g = torch.Generator().manual_seed(r)
    E, nb, n, m = 1, 2, 96, 160
    W = 0.05 * torch.randn(nb, n, m, generator=g)
    U, V = torch.randn(E, n, r, generator=g), torch.randn(E, m, r, generator=g)
    A = 1e-2 * torch.randn(E, nb, r, r, generator=g)
    exact = W.double() + torch.einsum(
        "enr,ebrs,ems->bnm", U.double(), A.double(), V.double())
    f32_tol = 1e-5 + 1e-5 * exact.abs()
    ulp = 2.0 ** (torch.floor(torch.log2(exact.abs())) - 7)
    bf16_tol = ulp + 1e-5
    three, one = tc_update(W, U, A, V), tc_update(W, U, A, V, split=False)
    assert ((three.double() - exact).abs() <= f32_tol / 4).all()
    assert ((three.double() - exact).abs() <= bf16_tol / 4).all()
    assert ((one.double() - exact).abs() > 10 * f32_tol).any()
    assert ((one.double() - exact).abs() > 10 * bf16_tol).any()
