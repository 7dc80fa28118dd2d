"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test carries the ``gpu`` marker and skips without a CUDA device (the
kernels have no CPU mode); ``chip_smoke.py`` also holds them at the main
path's shapes.  This file imports neither JAX nor the JAX
package, so it runs on a machine without them:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerance: rtol 1e-5, atol 1e-5 (float32, different summation orders).
Shapes are ragged on purpose: M, N and K off the tile sizes, W a strided
view of stacked layers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops  # noqa: E402

RTOL = ATOL = 1e-5


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("trans", [False, True])
def test_rank1_kernel_matches_plain(cuda, trans):
    rng = np.random.default_rng(5)
    C, M, K, N = 3, 67, 50, 133
    x = _f32(rng, C, M, K)
    W = _f32(rng, C, N, K) if trans else _f32(rng, C, K, N)
    u = _f32(rng, C, N if trans else K)
    v = _f32(rng, C, K if trans else N)
    s = np.array([1e-3, -1e-3, 0.5], np.float32)
    t = [torch.from_numpy(a).to(cuda) for a in (x, W, u, v, s)]
    Wst = torch.stack([t[1], t[1]], dim=1)[:, 1]          # (C, ., .) view
    fn = ops.rank1_matmul_t if trans else ops.rank1_matmul
    build.reset_launches()
    got = fn(t[0], Wst, t[2], t[3], t[4])
    torch.cuda.synchronize()
    assert sum(build.LAUNCHES.values()) == 1
    plain = fn(*(a.cpu() for a in t))
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("E", [1, 2, 4])
def test_subcge_kernels_match_plain(cuda, E):
    rng = np.random.default_rng(6 + E)
    W = _f32(rng, 2, 3, 70, 150)
    U, V = _f32(rng, E, 70, 16), _f32(rng, E, 150, 16)
    A = 0.1 * _f32(rng, E, 2, 3, 16, 16)
    t = [torch.from_numpy(a).to(cuda) for a in (W, U, A, V)]
    if E == 1:
        got = ops.subcge_apply(t[0], t[1][0], t[2][0], t[3][0])
    else:
        got = ops.subcge_apply_epochs(*t)
    ops.subcge_apply_epochs(t[0], *t[1:], inplace=True)
    torch.cuda.synchronize()
    plain = ops.subcge_apply_epochs(*(torch.from_numpy(a) for a in (W, U, A, V)))
    for out in (got, t[0]):
        np.testing.assert_allclose(out.cpu().numpy(), plain.numpy(),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_rank1_expert_kernel_matches_plain(cuda):
    """W is the strided (C, E, K, N) view of stacked (C, L, E, K, N) params
    at layer 1; M = 83 (a Kimi capacity) masks the row edge."""
    rng = np.random.default_rng(8)
    C, L, E, M, K, N = 2, 2, 3, 83, 50, 133
    x = torch.from_numpy(_f32(rng, C, E, M, K)).to(cuda)
    Wst = torch.from_numpy(_f32(rng, C, L, E, K, N)).to(cuda)
    u = torch.from_numpy(_f32(rng, C, E, K)).to(cuda)
    v = torch.from_numpy(_f32(rng, C, E, N)).to(cuda)
    s = torch.tensor([1e-3, -0.5], device=cuda)
    build.reset_launches()
    got = ops.rank1_matmul_expert(x, Wst[:, 1], u, v, s)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rank1_matmul_expert"] == 1
    plain = ops.rank1_matmul_expert(*(a.cpu() for a in (x, Wst[:, 1], u, v, s)))
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.gpu
def test_normal_on_card_is_bitwise_the_cpu(cuda):
    """The XLA-CPU rounding of prng.normal (float64-emulated fused
    multiply-adds, correctly rounded sqrt) holds on the card too."""
    from repro_torch.core import prng
    keys = prng.PRNGKey(torch.tensor([0, 7, 2**32 - 1]))
    want = prng.normal(keys, (1 << 14,))
    got = prng.normal(keys.to(cuda), (1 << 14,)).cpu()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("btdn", [(2, 37, 96, 4), (3, 33, 160, 8),
                                  (2, 70, 72, 16), (8, 33, 8192, 16)],
                         ids=["N4", "N8", "N16", "falcon-B8"])
def test_selective_scan_kernel_matches_plain(cuda, btdn):
    """N ∈ {4, 8, 16}, T off the kernel's 8-step prefetch, D·N off its
    256-thread block; the last case is Falcon Mamba 7B's layer with the
    folded client-batch axis cut from 64 to 8."""
    B, T, D, N = btdn
    rng = np.random.default_rng(sum(btdn))
    a = 1.0 / (1.0 + np.exp(-_f32(rng, B, T, D, N)))
    t = [torch.from_numpy(x.astype(np.float32)).to(cuda)
         for x in (a, 0.1 * _f32(rng, B, T, D, N), _f32(rng, B, T, N),
                   _f32(rng, B, D, N))]
    build.reset_launches()
    y, h = ops.selective_scan(*t)
    torch.cuda.synchronize()
    assert build.LAUNCHES["selective_scan"] == 1
    want_y, want_h = ops.selective_scan(*(x.cpu() for x in t))
    np.testing.assert_allclose(y.cpu().numpy(), want_y.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(h.cpu().numpy(), want_h.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.gpu
def test_selective_scan_refuses_unsupported_state(cuda):
    """N = 12 is not a power of two: the kernel raises, never falls back."""
    a = torch.zeros((1, 4, 8, 12), device=cuda)
    c, h0 = torch.zeros((1, 4, 12), device=cuda), torch.zeros((1, 8, 12),
                                                               device=cuda)
    build.reset_launches()
    with pytest.raises(ValueError, match="d_state"):
        ops.selective_scan(a, a, c, h0)
    assert build.LAUNCHES["selective_scan"] == 0
