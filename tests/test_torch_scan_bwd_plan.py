"""The geometry of the scan's backward kernel, ``selective_scan.scan_bwd_plan``
(CPU).

The kernel (``csrc/selective_scan_bwd.cu``) takes tiles of 128 state
elements × up to ``chunk`` steps through shared memory; ``scan_bwd_plan``
decides the tiles of each block, the number of blocks (= float64 dc
partials) per batch row, the chunks, the checkpoint buffer and the shared
memory.  Held here: at the scan shapes of phase 9's first-order Mamba arms
(the Falcon Mamba cut's d_inner 8192, N 16, T 33, dsgd's 4 and choco's 3
clients × 8 sequences folded into B), one chunk and at most a quarter of
the 512 partial blocks the one-thread-per-element design left; past a
chunk, ceil(T / chunk) chunks; every state size within a block's shared
memory; N = 12 refused.
"""
import pytest

pytest.importorskip("torch")

from _torch_parity import one_thread  # noqa: E402,F401
from repro_torch.configs import archs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402

#: partial blocks per batch row of the one-thread-per-element design at
#: (D, N) = (8192, 16): one per 256 state elements
OLD_PARTIALS = 8192 * 16 // 256


def _unit_shapes():
    """(B, T, D, N) of the backward in phase 9's dsgd and choco arms."""
    m = archs.falcon_cut().groups[0].slots[0].mamba
    return [(clients * 8, 33, m.d_inner, m.d_state) for clients in (4, 3)]


def test_plan_is_pure(one_thread, monkeypatch):
    """Equal plans for equal shapes, computed without building or loading
    anything, and a plan that covers every state element exactly once."""
    monkeypatch.setattr(build, "load", None)
    ss.scan_bwd_plan.cache_clear()
    for shape in _unit_shapes() + [(3, 37, 200, 16), (2, 11, 37, 2)]:
        p = ss.scan_bwd_plan(*shape)
        ss.scan_bwd_plan.cache_clear()
        assert ss.scan_bwd_plan(*shape) == p
        DN = shape[2] * shape[3]
        assert p.tiles * p.cols >= DN > (p.tiles - 1) * p.cols
        assert p.partials * p.per >= p.tiles > (p.partials - 1) * p.per
        assert p.bulk == (shape[2] % 4 == 0 and shape[3] >= 4)


def test_unit_shapes_take_one_chunk_and_a_quarter_of_the_partials(
        one_thread):
    for B, T, D, N in _unit_shapes():
        assert (D, N, T) == (8192, 16, 33)
        p = ss.scan_bwd_plan(B, T, D, N)
        assert (p.chunks, p.rows) == (1, T) and p.chunk >= 64
        assert p.ckpt_shape == (B, 0, D, N)
        assert 4 * p.partials <= OLD_PARTIALS
        assert p.part_shape == (B, T, p.partials, N)
        # the float64 partial buffer: at most 17.3 MB at dsgd's B = 32
        assert 8 * B * T * p.partials * N <= 17_301_504
        assert p.bulk


def test_long_t_takes_chunks_and_checkpoints(one_thread):
    """T = chunk is one chunk; T = chunk + 1 and T = 4 chunks + 5 take
    ceil(T / chunk) chunks, a checkpoint of h at every chunk start after
    the first, and a ring of full chunks."""
    B, D, N = 2, 72, 16
    at_chunk = ss.scan_bwd_plan(B, ss.BWD_CHUNK, D, N)
    assert (at_chunk.chunks, at_chunk.ckpt_shape) == (1, (B, 0, D, N))
    for T in (ss.BWD_CHUNK + 1, 4 * ss.BWD_CHUNK + 5):
        p = ss.scan_bwd_plan(B, T, D, N)
        chunks = -(-T // p.chunk)
        assert p.chunks == chunks >= 2
        assert p.rows == p.chunk
        assert p.ckpt_shape == (B, chunks - 1, D, N)
        assert p.part_shape == (B, T, p.partials, N)


def test_shared_memory_fits_a_block_for_every_state_size(one_thread):
    """At the largest tile (T past a chunk) every N in SUPPORTED_N fits the
    232,448 bytes a block may use on sm_90, and the smem formula counts the
    ring (a, bx, dy, c, start state and dh_last of a tile per stage, each
    padded to 128 bytes), the block's float64 dc partials and four
    mbarriers."""
    def pad(floats):
        return -(-floats // 32) * 32
    for N in ss.SUPPORTED_N:
        p = ss.scan_bwd_plan(2, 5 * ss.BWD_CHUNK, 4096, N)
        assert p.smem_bytes <= ss.SMEM_LIMIT
        stage = (2 * p.rows * p.cols + pad(p.rows * p.cols // N)
                 + pad(p.rows * N) + 2 * p.cols)
        assert p.smem_bytes == 2 * 4 * stage + p.rows * N * 8 + 32


def test_unsupported_state_is_refused(one_thread):
    with pytest.raises(ValueError, match="d_state N=12"):
        ss.scan_bwd_plan(1, 4, 8, 12)
    for B, T, D in ((0, 4, 8), (1, 0, 8), (1, 4, 0), (65536, 4, 8)):
        with pytest.raises(ValueError, match="unsupported shape"):
            ss.scan_bwd_plan(B, T, D, 16)
