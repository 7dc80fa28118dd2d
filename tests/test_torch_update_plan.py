"""The geometry of the SubCGE update kernel, ``subcge_apply.update_plan`` (CPU).

The kernel walks a persistent grid over (instance, column chunk, row tile);
``update_plan`` decides the chunk width, the tile height, the tiles of each
block and the shared memory; ``plan_tiles`` below is the kernel's tile map
in Python.  Here the plan is held, for every matrix leaf of the main paths'
updates (Qwen1.5-0.5B, the Kimi K2 cut, the Falcon Mamba 7B cut at 8
clients; OPT-125M at 64 clients, the paper's 8 x 8 mesh-grid) and for
ragged shapes, to cover every element exactly once, and to refuse what the
kernel refuses.
"""
import math

import numpy as np
import pytest

pytest.importorskip("torch")

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
