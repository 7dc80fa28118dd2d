"""The port's kernels on the CPU: their plain versions against the JAX kernels.

On the CPU each wrapper runs its plain PyTorch version; that version is
held against ``repro.kernels.ops`` under both ``jnp`` (the oracle) and
``interpret`` (the real Pallas kernel bodies).  Tolerance for every float32
comparison: rtol 1e-5, atol 1e-5 — the three implementations accumulate
the same float32 products in different orders.

The CUDA kernels run only on a card: their tests are in
test_torch_kernels_gpu.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402

RTOL = ATOL = 1e-5
BACKENDS = ("jnp", "interpret")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _rank1_inputs(rng, C, M, K, N, trans):
    x = _f32(rng, C, M, K)
    W = _f32(rng, C, N, K) if trans else _f32(rng, C, K, N)
    u = _f32(rng, C, N if trans else K)
    v = _f32(rng, C, K if trans else N)
    s = np.array([1e-3, -1e-3, 0.5][:C], np.float32)
    return x, W, u, v, s


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("trans", [False, True])
def test_rank1_plain_matches_jax(backend, trans):
    x, W, u, v, s = _rank1_inputs(_rng(1), 3, 12, 16, 40, trans)
    fn_t = ops.rank1_matmul_t if trans else ops.rank1_matmul
    fn_j = jops.rank1_matmul_t if trans else jops.rank1_matmul
    got = fn_t(*(torch.from_numpy(a) for a in (x, W, u, v, s))).numpy()
    for c in range(3):
        want = np.asarray(fn_j(x[c], W[c], u[c], v[c], s[c], backend=backend))
        np.testing.assert_allclose(got[c], want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_subcge_apply_plain_matches_jax(backend):
    rng = _rng(2)
    W, U, V = _f32(rng, 2, 3, 16, 24), _f32(rng, 16, 4), _f32(rng, 24, 4)
    A = _f32(rng, 2, 3, 4, 4)
    got = ops.subcge_apply(*(torch.from_numpy(a) for a in (W, U, A, V)))
    want = np.asarray(jops.subcge_apply(W, U, A, V, backend=backend))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    Wt = torch.from_numpy(W.copy())
    out = ops.subcge_apply(Wt, *(torch.from_numpy(a) for a in (U, A, V)),
                           inplace=True)
    assert out is Wt
    np.testing.assert_allclose(Wt.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("E,live", [(1, 1), (2, 2), (4, 3)])
def test_subcge_apply_epochs_plain_matches_jax(backend, E, live):
    rng = _rng(3 + E)
    W = _f32(rng, 2, 3, 16, 24)
    U, V = _f32(rng, E, 16, 4), _f32(rng, E, 24, 4)
    A = _f32(rng, E, 2, 3, 4, 4)
    A[live:] = 0.0          # padded epoch slots carry no message
    got = ops.subcge_apply_epochs(*(torch.from_numpy(a) for a in (W, U, A, V)))
    want = np.asarray(jops.subcge_apply_epochs(W, U, A, V, backend=backend))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("E,r", [(1, 48), (2, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_core_formulation_matches_jax(E, r, dtype):
    """The tensor-core kernel's arithmetic past rank 32 (``tc_update`` in
    test_torch_update_plan.py: each epoch's r padded to ``stream_plan``'s
    rp, A V^T = blockdiag(A_e) [V_1 ... V_E]^T, the delta in TF32 split in
    three with float32 sums) gives the JAX package's rank-r update (its jnp
    oracle) on a small stacked leaf: float32 within rtol / atol 1e-5, bf16
    W within one bf16 ulp + 1e-5 of the JAX bf16 update."""
    from test_torch_update_plan import tc_update
    rng = _rng(10 + r)
    W = _f32(rng, 2, 3, 16, 24)
    U, V = _f32(rng, E, 16, r), _f32(rng, E, 24, r)
    A = _f32(rng, E, 2, 3, r, r) / r
    Wt = torch.from_numpy(W).to(getattr(torch, dtype))
    got = tc_update(Wt.reshape(6, 16, 24), torch.from_numpy(U),
                    torch.from_numpy(A).reshape(E, 6, r, r),
                    torch.from_numpy(V)).reshape(2, 3, 16, 24)
    Wj = W if dtype == "float32" else Wt.float().numpy()
    want = np.asarray(jops.subcge_apply_epochs(Wj, U, A, V, backend="jnp"))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    else:
        w = torch.from_numpy(want).to(torch.bfloat16).float()
        ulp = 2.0 ** (torch.floor(torch.log2(w.abs())) - 7)
        assert ((got.float() - w).abs() <= ulp + ATOL).all()


def test_non_cpu_tensors_never_reach_the_plain_version():
    x = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.rank1_matmul(x, torch.empty((1, 8, 4), device="meta"),
                         torch.empty((1, 8), device="meta"),
                         torch.empty((1, 4), device="meta"),
                         torch.empty((1,), device="meta"))
    assert not build.LAUNCHES
