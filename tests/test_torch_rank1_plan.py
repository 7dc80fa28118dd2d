"""The split-K plan of ``rank1_matmul``, ``rank1_matmul_expert`` and
``rank1_matmul_t`` (CPU).

``split_plan`` is the pure function of the shape that decides how the
kernel's K loop is cut; it runs here for every shape the main paths give
the two kernels: Qwen1.5-0.5B, the Kimi K2 cut (``archs.kimi_cut``: 32 of
384 experts, the router cut with them, vocab 20480) and the Falcon Mamba 7B
cut (``archs.falcon_cut``), 8 clients × 264 rows (8 sequences of 33
tokens), and a Kimi expert's capacity of 83 rows; and OPT-125M at 64
clients (the paper's 8 x 8 mesh-grid) × 264 rows.
"""
import math

import pytest

pytest.importorskip("torch")

from repro_torch.configs import archs  # noqa: E402
from repro_torch.kernels import rank1_matmul as r1  # noqa: E402

C, M = 8, 8 * 33
#: clients of the paper-setting path (OPT-125M on the 8 x 8 mesh-grid)
C_PAPER = 64


def _main_path_shapes():
    """name -> (batch, M, N, K) of every rank1 product on the main paths."""
    q = archs.get("qwen1.5-0.5b")
    d, ff = q.d_model, q.groups[0].slots[0].d_ff
    shapes = {"qwen/attn": (C, M, d, d), "qwen/up": (C, M, ff, d),
              "qwen/down": (C, M, d, ff),
              # the tied logits, rank1_matmul_t: N = the vocabulary
              "qwen/logits_t": (C, M, q.vocab, d)}
    k = archs.kimi_cut()
    slot = k.groups[0].slots[0]
    a, mo, d = slot.attn, slot.moe, k.d_model
    cap = math.ceil(M * mo.top_k / mo.n_experts * mo.capacity_factor)
    shapes.update({
        "kimi/q": (C, M, a.n_heads * a.head_dim, d),
        "kimi/kv": (C, M, a.n_kv_heads * a.head_dim, d),
        "kimi/o": (C, M, d, a.n_heads * a.head_dim),
        "kimi/router": (C, M, mo.n_experts, d),
        "kimi/shared_up": (C, M, mo.n_shared * mo.d_ff_expert, d),
        "kimi/shared_down": (C, M, d, mo.n_shared * mo.d_ff_expert),
        "kimi/head": (C, M, k.vocab, d),
        "kimi/expert_up": (C * mo.n_experts, cap, mo.d_ff_expert, d),
        "kimi/expert_down": (C * mo.n_experts, cap, d, mo.d_ff_expert),
    })
    f = archs.falcon_cut()
    m, d = f.groups[0].slots[0].mamba, f.d_model
    dtr = m.dt_rank or -(-d // 16)
    shapes.update({
        "falcon/in_proj": (C, M, 2 * m.d_inner, d),
        "falcon/x_proj": (C, M, dtr + 2 * m.d_state, m.d_inner),
        "falcon/dt_proj": (C, M, m.d_inner, dtr),
        "falcon/out_proj": (C, M, d, m.d_inner),
        "falcon/head": (C, M, f.vocab, d),
    })
    o = archs.get("opt-125m")
    d, ff = o.d_model, o.groups[0].slots[0].d_ff
    shapes.update({
        "opt/attn": (C_PAPER, M, d, d), "opt/up": (C_PAPER, M, ff, d),
        "opt/down": (C_PAPER, M, d, ff),
        "opt/logits_t": (C_PAPER, M, o.vocab, d),
    })
    return shapes


SHAPES = _main_path_shapes()


def _tiles(batch, M, N, K):
    return batch * -(-M // r1.TILE_M) * -(-N // r1.TILE_N)


def test_shapes_are_the_published_ones():
    """The table above reads the registry: spot-check the widths the plan
    is for (Kimi's router and Falcon's x_proj are the narrow outputs)."""
    assert SHAPES["kimi/router"] == (8, 264, 32, 7168)
    assert SHAPES["falcon/x_proj"] == (8, 264, 288, 8192)
    assert SHAPES["kimi/expert_up"] == (256, 83, 2048, 7168)
    assert SHAPES["falcon/head"] == (8, 264, 65024, 4096)
    assert SHAPES["qwen/logits_t"] == (8, 264, 151936, 1024)
    assert SHAPES["opt/up"] == (64, 264, 3072, 768)
    assert SHAPES["opt/logits_t"] == (64, 264, 50272, 768)


def test_tied_logits_take_one_split_within_grid_limits():
    """rank1_matmul_t on Qwen's tied logits: 28,488 output tiles fill the
    card, so K is not split; the grid (row tiles, column tiles, clients)
    stays inside CUDA's y and z limits."""
    batch, M, N, K = SHAPES["qwen/logits_t"]
    assert r1.split_plan(batch, M, N, K) == (1, K)
    assert _tiles(batch, M, N, K) == 28_488
    assert -(-N // r1.TILE_N) <= r1.GRID_YZ and batch <= r1.GRID_YZ


@pytest.mark.parametrize("name", ["opt/attn", "opt/up", "opt/down",
                                  "opt/logits_t"])
def test_opt_shapes_fill_the_card_unsplit(name):
    """At 64 clients every OPT-125M product, the tied logits included, has
    tiles for at least two waves: one split, inside the grid's limits."""
    batch, M, N, K = SHAPES[name]
    assert _tiles(batch, M, N, K) >= 2 * r1.SLOTS
    assert r1.split_plan(batch, M, N, K) == (1, K)
    assert -(-N // r1.TILE_N) <= r1.GRID_YZ and batch <= r1.GRID_YZ


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_splits_cover_k_in_whole_slabs(name):
    batch, M, N, K = SHAPES[name]
    splits, kper = r1.split_plan(batch, M, N, K)
    assert splits >= 1 and kper % r1.TILE_K == 0
    # the last split starts inside K and ends at or past it: every split
    # is non-empty and together they cover K exactly once
    assert (splits - 1) * kper < K <= splits * kper
    assert r1.split_plan(batch, M, N, K) == (splits, kper)   # pure


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_shapes_that_fill_the_card_take_one_split(name):
    """Two waves of output tiles over the card's block slots take one
    split; no shape is cut into more than MAX_SPLITS."""
    batch, M, N, K = SHAPES[name]
    splits, _ = r1.split_plan(batch, M, N, K)
    if _tiles(batch, M, N, K) >= 2 * r1.SLOTS:
        assert splits == 1
    assert splits <= r1.MAX_SPLITS


@pytest.mark.parametrize("name", ["kimi/router", "falcon/x_proj"])
def test_narrow_outputs_get_two_waves(name):
    """The router (N = 32) and x_proj (N = 288) leave most of the 132 SMs
    idle unsplit; split, they launch at least two blocks per SM."""
    batch, M, N, K = SHAPES[name]
    splits, _ = r1.split_plan(batch, M, N, K)
    tiles = _tiles(batch, M, N, K)
    assert tiles < r1.SMS
    assert tiles * splits >= 2 * r1.SMS


def test_wide_outputs_split_only_where_the_clock_gains():
    """Of the main paths' shapes, only those whose tiles leave block slots
    idle and whose K is long enough to pay for the partial sums split."""
    split = sorted(n for n, sh in SHAPES.items() if r1.split_plan(*sh)[0] > 1)
    assert split == ["falcon/x_proj", "kimi/kv", "kimi/router",
                     "kimi/shared_up", "qwen/down"]


@pytest.mark.parametrize("shape", [(3, 67, 133, 50), (6, 83, 133, 50),
                                   (1, 1, 1, 7), (1, 1, 1, 16 * 300)])
def test_ragged_shapes(shape):
    """The gpu tests' ragged shapes: K not a multiple of the slab, or a
    single row and column; splits never exceed the slabs."""
    batch, M, N, K = shape
    splits, kper = r1.split_plan(*shape)
    assert splits <= -(-K // r1.TILE_K)
    assert (splits - 1) * kper < K <= splits * kper


def _pod_shapes():
    """name -> (batch, M, N, K) of the bf16 pod step's products: InternVL2-26B
    with 8 clients sharing one W, M = 2 x (1024 patches + 33 tokens); the
    projector at M = 2 x 1024."""
    v = archs.get("internvl2-26b")
    slot = v.groups[0].slots[0]
    a, d, ff = slot.attn, v.d_model, slot.d_ff
    M = 2 * (v.frontend.n_embeds + 33)
    return {"internvl/q": (8, M, a.n_heads * a.head_dim, d),
            "internvl/kv": (8, M, a.n_kv_heads * a.head_dim, d),
            "internvl/up": (8, M, ff, d), "internvl/down": (8, M, d, ff),
            "internvl/logits": (8, M, v.vocab, d),
            "internvl/proj": (8, 2 * v.frontend.n_embeds, d,
                              v.frontend.embed_dim)}


@pytest.mark.parametrize("name", sorted(SHAPES) + sorted(_pod_shapes()))
def test_bf16_splits_cover_k_in_whole_slabs(name):
    """The bf16 kernel's plan (``TILE16``: 128 x 256 outputs, 64-k slabs,
    one persistent block an SM): whole slabs, K covered exactly once, one
    split where the output tiles fill two waves of its blocks, at most
    MAX_SPLITS."""
    batch, M, N, K = {**SHAPES, **_pod_shapes()}[name]
    splits, kper = r1.split_plan(batch, M, N, K, bf16=True)
    tm, tn, tk = r1.TILE16
    assert splits >= 1 and kper % tk == 0
    assert (splits - 1) * kper < K <= splits * kper
    if batch * -(-M // tm) * -(-N // tn) >= 2 * r1.SMS * r1.BLOCKS_PER_SM16:
        assert splits == 1
    assert splits <= r1.MAX_SPLITS
    assert r1.split_plan(batch, M, N, K, bf16=True) == (splits, kper)


@pytest.mark.parametrize("C,E,M,K,sx_c,sw_c,want", [
    (8, 1, 2114, 6144, 2114 * 6144, 0, True),     # the pod: one W, x packed
    (8, 1, 2114, 6144, 2 * 2114 * 6144, 0, False),   # x strided over C
    (8, 1, 2114, 6144, 2114 * 6144, 6144 ** 2, False),   # a W per client
    (3, 2, 330, 8192, 2 * 330 * 8192, 0, False),  # experts never fold
    (1, 1, 264, 1024, 264 * 1024, 0, False),      # one client: nothing to fold
])
def test_fold_decision(C, E, M, K, sx_c, sw_c, want):
    """The clients' rows fold into one product only over one shared W with
    x contiguous over (C, M), and without experts."""
    assert r1.folds(C, E, M, K, sx_c, sw_c) is want


@pytest.mark.parametrize("name", sorted(_pod_shapes()))
def test_pod_products_fold_into_one(name):
    """At InternVL2-26B's pod the 8 clients' rows are one product: 133 row
    tiles of 128 for 16,912 rows (8 x 17 tiles, the last 56 % full, when
    each client is its own product); the plan of the folded product."""
    C, M, N, K = _pod_shapes()[name]
    assert r1.folds(C, 1, M, K, M * K, 0)
    splits, kper = r1.gemm_plan(C, 1, M, N, K, bf16=True, fold=True)
    assert (splits, kper) == r1.split_plan(1, C * M, N, K, bf16=True)
    assert (splits - 1) * kper < K <= splits * kper
    tm, tn, _ = r1.TILE16
    if name != "internvl/proj":
        assert -(-C * M // tm) == 133 < C * -(-M // tm)


@pytest.mark.parametrize("S,rt,ct,group", [(1, 133, 24, 16), (3, 3, 1, 16),
                                           (2, 17, 5, 4), (1, 1, 362, 16)])
def test_tile_order_visits_every_tile_once(S, rt, ct, group):
    """The persistent blocks' raster (``tile_of``): every (product, split,
    row tile, column tile) exactly once, products and splits outermost,
    and the tiles of one band within ``group`` row tiles."""
    B = 2
    seen = [r1.tile_of(t, S, rt, ct, group) for t in range(B * S * rt * ct)]
    assert len(set(seen)) == len(seen) == B * S * rt * ct
    assert all(0 <= b < B and 0 <= s < S and 0 <= i < rt and 0 <= j < ct
               for b, s, i, j in seen)
    lo = 0
    for _ in range(B * S):
        for first in range(0, rt, group):
            n = min(group, rt - first) * ct
            assert {i for _, _, i, _ in seen[lo:lo + n]} == \
                set(range(first, min(rt, first + group)))
            lo += n
