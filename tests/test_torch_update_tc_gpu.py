"""The tensor-core update kernel (``update_tc_kernel`` in
``csrc/subcge_apply.cu``) against its plain PyTorch version, on a card.

It takes every launch with bf16 W, and float32 W past rank 32; float32 at
r <= 32 keeps the stream (``test_torch_kernels_gpu.py``).  Every test
carries the ``gpu`` marker and skips without a CUDA device.  This file
imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_update_tc_gpu.py

Tolerance: float32 rtol 1e-5, atol 1e-5 (the delta in TF32 split in three
and float32 sums, against the plain version's float32 einsum); bf16 one bf16
ulp of the plain version plus atol 1e-5 (both round f32(W) + delta once,
from float32 sums in other orders).  Every result is also the same bits
on a second call.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import subcge_apply as sa  # noqa: E402

RTOL = ATOL = 1e-5
DTYPES = ("float32", "bfloat16")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, seed, dtype, E, C, L, n, m, r):
    """Stacked (C, L, n, m) params at scale 0.05 in ``dtype``, U (E, n, r)
    and V (E, m, r) standard normal, A (E, C, r, r) at scale 1e-2 (the
    deltas of a few messages, comparable to W)."""
    rng = np.random.default_rng(seed)
    Wst = torch.from_numpy(0.05 * rng.standard_normal((C, L, n, m)).astype(
        np.float32)).to(cuda).to(getattr(torch, dtype))
    U = rng.standard_normal((E, n, r)).astype(np.float32)
    V = rng.standard_normal((E, m, r)).astype(np.float32)
    A = 1e-2 * rng.standard_normal((E, C, r, r)).astype(np.float32)
    return (Wst, *(torch.from_numpy(a).to(cuda) for a in (U, A, V)))


def _close(got, want, what):
    g, w = got.float().cpu(), want.float().cpu()
    if got.dtype == torch.bfloat16:
        tol = torch.where(w == 0, torch.zeros_like(w),
                          2.0 ** (torch.floor(torch.log2(w.abs())) - 7)) + ATOL
    else:
        tol = ATOL + RTOL * w.abs()
    bad = (g - w).abs() > tol
    assert not bool(bad.any()), (what, int(bad.sum()),
                                 float((g - w).abs().max()))


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _update(W, U, A, V, inplace=False):
    """One launch through the wrapper the main paths call (subcge_apply at
    E = 1, subcge_apply_epochs otherwise)."""
    if U.shape[0] == 1:
        return ops.subcge_apply(W, U[0], A[0], V[0], inplace=inplace)
    return ops.subcge_apply_epochs(W, U, A, V, inplace=inplace)


def _name(dtype, E):
    name = "subcge_apply" if E == 1 else "subcge_apply_epochs"
    return name + ("_bf16" if dtype == "bfloat16" else "")


# cases loop inside the tests (few collected tests: under `--dist loadfile`
# a file is dispatched by its count of tests, most first)

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r", [16, 33, 64, 128])
def test_tc_kernel_matches_plain(cuda, dtype, r):
    """Every (E, r) of E in {1, 2, 4} x r in {16, 33, 64, 128} in both
    types, on two instances of a 300 x 200 leaf (ragged against the 128 x
    64 tile): k = E rp from 16 to 512, so k past 128 walks its groups;
    float32 at r = 16 is the stream's, the rest the tensor-core kernel's.
    Bitwise twice."""
    for E in (1, 2, 4):
        Wst, U, A, V = _inputs(cuda, E * 1000 + r, dtype, E, 2, 1, 300, 200,
                               r)
        W = Wst[:, 0]
        build.reset_launches()
        got = _update(W, U, A, V)
        again = _update(W, U, A, V)
        torch.cuda.synchronize()
        assert dict(build.LAUNCHES) == {_name(dtype, E): 2}
        assert torch.equal(_bits(got), _bits(again))
        want = sa.subcge_apply_epochs_plain(*(t.cpu() for t in (W, U, A, V)))
        _close(got, want, (dtype, E, r))


# (n, m): m = 92,553 (InternVL2-26B's untied logits) and m = 150 / 36 /
# 1001 take the flat path in bf16 (rows off 16 bytes), 92,553 and 1001 in
# float32 too; n = 1 and 129 against the 128-row tile; m = 8 a narrow leaf
RAGGED = [(64, 92_553), (129, 150), (1, 36), (300, 1001), (200, 8),
          (257, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_tc_kernel_ragged_shapes(cuda, dtype):
    """Ragged n and m (RAGGED), through TMA and through the flat view, at
    E = 1 and 2, r = 16 (bf16) or 64 (float32)."""
    r = 16 if dtype == "bfloat16" else 64
    for (n, m), E in ((nm, E) for nm in RAGGED for E in (1, 2)):
        Wst, U, A, V = _inputs(cuda, n + m + E, dtype, E, 1, 1, n, m, r)
        W = Wst[:, 0]
        got = _update(W, U, A, V)
        again = _update(W, U, A, V)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(again))
        want = sa.subcge_apply_epochs_plain(*(t.cpu() for t in (W, U, A, V)))
        _close(got, want, (dtype, n, m, E))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_tc_kernel_in_place_on_stacked_view(cuda, dtype):
    """In place on the strided (3, n, m) view of stacked (3, 2, n, m)
    params at layer 1 (off 16 bytes where n m is odd: the flat path): the
    result is the out-of-place one bit for bit, the other layer is
    untouched, and one launch counts (float32 at r = 16: the stream's)."""
    for shape in ((1, 300, 200, 64), (2, 129, 150, 33), (4, 70, 92, 16),
                  (1, 33, 1000, 128)):
        E, n, m, r = shape
        Wst, U, A, V = _inputs(cuda, sum(shape), dtype, E, 3, 2, n, m, r)
        W, layer0 = Wst[:, 1], Wst[:, 0].clone()
        before = W.clone()   # contiguous: aligned, so TMA where m allows
        want = _update(before, U, A, V)
        build.reset_launches()
        out = _update(W, U, A, V, inplace=True)
        torch.cuda.synchronize()
        assert out is W and dict(build.LAUNCHES) == {_name(dtype, E): 1}
        assert torch.equal(_bits(W), _bits(want))
        assert torch.equal(_bits(Wst[:, 0]), _bits(layer0))
        _close(W, sa.subcge_apply_epochs_plain(
            *(t.cpu() for t in (before, U, A, V))), (dtype, shape))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_tc_kernel_is_bitwise_across_calls(cuda, dtype):
    """Two calls on the same inputs give the same bits at every E (no
    atomics), at a leaf of many tiles per block (8 x 1000 x 1024, r 64)."""
    for E in (1, 2, 4):
        Wst, U, A, V = _inputs(cuda, 70 + E, dtype, E, 8, 1, 1000, 1024, 64)
        W = Wst[:, 0]
        a, b = _update(W, U, A, V), _update(W, U, A, V)
        torch.cuda.synchronize()
        assert torch.equal(_bits(a), _bits(b)), (dtype, E)
