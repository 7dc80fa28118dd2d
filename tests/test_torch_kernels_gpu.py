"""The port's CUDA kernels against their plain PyTorch versions, on a card
(and a full-width resume, bitwise).

Every test carries the ``gpu`` marker and skips without a CUDA device (the
kernels have no CPU mode); ``chip_smoke.py`` also holds them at the main
path's shapes.  This file imports neither JAX nor the JAX
package, so it runs on a machine without them:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerance: rtol 1e-5, atol 1e-5 (float32, different summation orders).
Shapes are ragged on purpose: M, N and K off the tile sizes, W a strided
view of stacked layers; the narrow outputs take the split-K path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import rank1_matmul as rank1  # noqa: E402
from repro_torch.kernels import selective_scan as sscan  # noqa: E402

RTOL = ATOL = 1e-5


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (M, K, N): ragged against the 88 x 128 tile and the 16-k slab, the Kimi
# router (N = 32) and Falcon's x_proj (N = 288), which split K, a single
# row and column, and Falcon's dt_proj (K = 256), which fills the card
RANK1_SHAPES = [(67, 50, 133), (264, 7168, 32), (264, 8192, 288), (1, 7, 1),
                (264, 256, 8192)]


def _rank1_inputs(cuda, seed, C, M, K, N, trans=False):
    """x (C, M, K), W the strided (C, ., .) view of stacked (C, 2, ., .)
    params at layer 1, u, v, s; W and the contracted vector are scaled by
    K^-1/2, so that x W and s (x·u) v stay near 1 at any K."""
    rng = np.random.default_rng(seed)
    x = _f32(rng, C, M, K)
    W = _f32(rng, C, 2, N, K) if trans else _f32(rng, C, 2, K, N)
    u = _f32(rng, C, N if trans else K)
    v = _f32(rng, C, K if trans else N)
    if trans:
        v = v * K ** -0.5
    else:
        u = u * K ** -0.5
    s = np.resize(np.array([1e-3, -1e-3, 0.5], np.float32), C)
    t = [torch.from_numpy(a).to(cuda) for a in (x, W * K ** -0.5, u, v, s)]
    t[1] = t[1][:, 1]
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("trans,mkn",
                         [(True, RANK1_SHAPES[0])]
                         + [(False, mkn) for mkn in RANK1_SHAPES],
                         ids=lambda a: "x".join(map(str, a))
                         if isinstance(a, tuple) else ("t" if a else "n"))
def test_rank1_kernel_matches_plain(cuda, trans, mkn):
    M, K, N = mkn
    C = 3 if M == 67 else 8
    t = _rank1_inputs(cuda, 5 + K, C, M, K, N, trans)
    fn = ops.rank1_matmul_t if trans else ops.rank1_matmul
    build.reset_launches()
    got = fn(*t)
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


def _update_inputs(cuda, seed, E, C, L, n, m, r):
    """The stacked (C, L, n, m) params, W their strided (C, n, m) view at
    layer L - 1, U (E, n, r), A (E, C, r, r), V (E, m, r); A scaled by r^-1
    so the delta stays near 1."""
    rng = np.random.default_rng(seed)
    Wst = torch.from_numpy(_f32(rng, C, L, n, m)).to(cuda)
    U, V = _f32(rng, E, n, r), _f32(rng, E, m, r)
    A = _f32(rng, E, C, r, r) / r
    return (Wst, Wst[:, L - 1],
            *(torch.from_numpy(a).to(cuda) for a in (U, A, V)))


# (E, n, m, r): ragged n against the tile rows; m % 4 != 0 (4-byte path),
# m < 128 (narrow chunks: Falcon's conv_w m = 4, A_log m = 16, the Kimi
# router m = 32), Falcon's x_proj m = 288; r in {1, 16, 32}; E = 5 at r = 32
# keeps A V^T of 4 epochs at a time, so it is rebuilt per tile
UPDATE_SHAPES = [(1, 70, 150, 16), (2, 300, 4, 16), (3, 1000, 16, 1),
                 (4, 65, 33, 32), (1, 517, 288, 16), (2, 129, 1024, 16),
                 (5, 200, 130, 32), (1, 3000, 32, 16),
                 # OPT-125M: the learned positions, w1 and w2, E = 1 and 2
                 (1, 4096, 768, 16), (1, 768, 3072, 16), (2, 3072, 768, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", UPDATE_SHAPES,
                         ids=lambda a: "E{}-n{}-m{}-r{}".format(*a))
def test_update_kernel_in_place_on_stacked_view(cuda, shape):
    """The streaming update in place on a strided view of stacked layers,
    held against the plain version; the other layer is untouched."""
    E, n, m, r = shape
    Wst, W, U, A, V = _update_inputs(cuda, sum(shape), E, 3, 2, n, m, r)
    layer0 = Wst[:, 0].clone()
    want = ops.subcge_apply_epochs(*(t.cpu() for t in (W, U, A, V)))
    build.reset_launches()
    if E == 1:
        out = ops.subcge_apply(W, U[0], A[0], V[0], inplace=True)
    else:
        out = ops.subcge_apply_epochs(W, U, A, V, inplace=True)
    torch.cuda.synchronize()
    assert out is W and sum(build.LAUNCHES.values()) == 1
    np.testing.assert_allclose(W.cpu().numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(Wst[:, 0], layer0)


# OPT-125M's products (M, K, N) on the paper-setting path: 64 clients of
# 264 rows (8 sequences of 33 tokens), the four attention projections, w1
# and w2
OPT_RANK1_SHAPES = [(264, 768, 768), (264, 768, 3072), (264, 3072, 768)]


@pytest.mark.gpu
@pytest.mark.parametrize("mkn", OPT_RANK1_SHAPES,
                         ids=lambda a: "x".join(map(str, a)))
def test_rank1_kernel_at_opt_shapes(cuda, mkn):
    M, K, N = mkn
    t = _rank1_inputs(cuda, 13 + N, 64, M, K, N)
    build.reset_launches()
    got = ops.rank1_matmul(*t)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rank1_matmul"] == 1
    plain = ops.rank1_matmul(*(a.cpu() for a in t))
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.gpu
def test_rank1_t_kernel_at_opt_tied_logits(cuda):
    """OPT-125M's tied logits, W (O = 50272, K = 768), for 2 of the 64
    clients (the CPU oracle of all 64 would take minutes)."""
    t = _rank1_inputs(cuda, 17, 2, 264, 768, 50272, trans=True)
    build.reset_launches()
    got = ops.rank1_matmul_t(*t)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rank1_matmul_t"] == 1
    plain = ops.rank1_matmul_t(*(a.cpu() for a in t))
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("trans,mkn", [(True, (264, 1152, 262_144)),
                                       (False, (264, 8192, 152_064))],
                         ids=["gemma-tied-logits", "qwen2-untied-logits"])
def test_rank1_kernels_at_the_widest_logits(cuda, trans, mkn):
    """Gemma 3 1B's tied logits (W (262144, 1152), rank1_matmul_t) and
    Qwen2-72B's untied ones (W (8192, 152064), rank1_matmul) for 2
    clients, each W past 2^31 bytes across the clients; made on the card
    and held against the plain version there (a CPU oracle would take
    minutes and tens of GB of host memory)."""
    M, K, N = mkn
    g = torch.Generator(device=cuda).manual_seed(N)
    C = 2

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=cuda) * scale

    x = randn(C, M, K)
    W = randn(C, N, K, scale=K ** -0.5) if trans else \
        randn(C, K, N, scale=K ** -0.5)
    u, v = (randn(C, N), randn(C, K, scale=K ** -0.5)) if trans else \
        (randn(C, K, scale=K ** -0.5), randn(C, N))
    s = torch.tensor([1e-3, -1e-3], device=cuda)
    fn = ops.rank1_matmul_t if trans else ops.rank1_matmul
    plain = rank1.rank1_matmul_t_plain if trans else rank1.rank1_matmul_plain
    build.reset_launches()
    got = fn(x, W, u, v, s)
    torch.cuda.synchronize()
    assert sum(build.LAUNCHES.values()) == 1
    want = plain(x, W, u, v, s)
    assert bool(torch.all((got - want).abs() <= ATOL + RTOL * want.abs()))


@pytest.mark.gpu
@pytest.mark.parametrize("E", [1, 2])
def test_update_kernel_is_deterministic(cuda, E):
    """Two calls on the same inputs give the same bits."""
    _, W, U, A, V = _update_inputs(cuda, 40 + E, E, 2, 2, 1000, 1024, 16)
    a, b = ops.subcge_apply_epochs(W, U, A, V), ops.subcge_apply_epochs(
        W, U, A, V)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("r", [33, 48, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_kernel_takes_any_rank(cuda, r, dtype):
    """r past the kernel's 32: the wrappers cut the update into blocks of
    rank 32 (``subcge_apply.rank_blocks``), one launch each; subcge_apply
    and subcge_apply_epochs at E = 1 and 2 agree with the plain version
    (float32: rtol / atol 1e-5; bf16: one bf16 ulp + atol) and give the
    same bits on a second call."""
    from repro_torch.kernels import subcge_apply as sa
    for E in (1, 2):
        _, W, U, A, V = _update_inputs(cuda, 50 + r + E, E, 2, 2, 70, 150, r)
        W = (0.05 * W).to(getattr(torch, dtype))
        build.reset_launches()
        if E == 1:
            got = ops.subcge_apply(W, U[0], A[0], V[0])
            again = ops.subcge_apply(W, U[0], A[0], V[0])
            want = sa.subcge_apply_plain(W, U[0], A[0], V[0])
            name = "subcge_apply"
        else:
            got = ops.subcge_apply_epochs(W, U, A, V)
            again = ops.subcge_apply_epochs(W, U, A, V)
            want = sa.subcge_apply_epochs_plain(W, U, A, V)
            name = "subcge_apply_epochs"
        torch.cuda.synchronize()
        name += "_bf16" if dtype == "bfloat16" else ""
        assert dict(build.LAUNCHES) == {name: 2}
        bits = torch.int16 if dtype == "bfloat16" else torch.int32
        assert torch.equal(got.view(bits), again.view(bits))
        if dtype == "bfloat16":
            _bf16_close(got, want, f"r={r} E={E}")
        else:
            assert bool(torch.all((got - want).abs()
                                  <= ATOL + RTOL * want.abs())), (r, E)


def _expert_inputs(cuda, seed, M, K, N):
    """W is the strided (C, E, K, N) view of stacked (C, L, E, K, N) params
    at layer 1; C = 2 clients, E = 3 experts; W and u scaled by K^-1/2."""
    rng = np.random.default_rng(seed)
    C, L, E = 2, 2, 3
    x = torch.from_numpy(_f32(rng, C, E, M, K)).to(cuda)
    Wst = torch.from_numpy(_f32(rng, C, L, E, K, N) * K ** -0.5).to(cuda)
    u = torch.from_numpy(_f32(rng, C, E, K) * K ** -0.5).to(cuda)
    v = torch.from_numpy(_f32(rng, C, E, N)).to(cuda)
    s = torch.tensor([1e-3, -0.5], device=cuda)
    return x, Wst[:, 1], u, v, s


@pytest.mark.gpu
@pytest.mark.parametrize("mkn", [(83, 50, 133), (83, 2048, 7168), (1, 7, 1)],
                         ids=lambda a: "x".join(map(str, a)))
def test_rank1_expert_kernel_matches_plain(cuda, mkn):
    """M = 83 (a Kimi capacity) masks the row edge; (83, 50, 133) splits K,
    (83, 2048, 7168) is Kimi's w2 with 3 of its 32 experts."""
    t = _expert_inputs(cuda, 8 + mkn[1], *mkn)
    build.reset_launches()
    got = ops.rank1_matmul_expert(*t)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rank1_matmul_expert"] == 1
    plain = ops.rank1_matmul_expert(*(a.cpu() for a in t))
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), rtol=RTOL,
                               atol=ATOL)


# (M, K, O) of rank1_matmul_t: M in {1, 67, 264}; O ragged against the
# 128-column tile; K = 50 takes the 4-byte path; Qwen's tied width K = 1024;
# (264, 8192, 288) splits K
RANK1_T_SHAPES = [(1, 64, 300), (67, 50, 133), (264, 1024, 1000),
                  (264, 8192, 288)]


@pytest.mark.gpu
@pytest.mark.parametrize("mko", RANK1_T_SHAPES,
                         ids=lambda a: "x".join(map(str, a)))
def test_rank1_t_kernel_matches_plain(cuda, mko):
    M, K, O = mko
    t = _rank1_inputs(cuda, 11 + K, 8, M, K, O, trans=True)
    build.reset_launches()
    got = ops.rank1_matmul_t(*t)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rank1_matmul_t"] == 1
    plain = ops.rank1_matmul_t(*(a.cpu() for a in t))
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,mkn", [("n", (264, 7168, 32)),
                                      ("n", (264, 256, 8192)),
                                      ("e", (83, 50, 133)),
                                      ("e", (83, 2048, 7168)),
                                      ("t", (264, 1024, 1000)),
                                      ("t", (264, 8192, 288))],
                         ids=["router-split", "dt_proj", "expert-split",
                              "expert-w2", "transposed", "transposed-split"])
def test_rank1_kernels_are_deterministic(cuda, kind, mkn):
    """No atomics: two calls on the same inputs give the same bits, with
    and without the split-K reduction."""
    t = (_expert_inputs(cuda, 1, *mkn) if kind == "e"
         else _rank1_inputs(cuda, 1, 8, *mkn, trans=kind == "t"))
    fn = {"n": ops.rank1_matmul, "e": ops.rank1_matmul_expert,
          "t": ops.rank1_matmul_t}[kind]
    a, b = fn(*t), fn(*t)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


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
def test_gumbel_on_card_is_bitwise_the_cpu(cuda):
    """prng.gumbel (the serving path's temperature sampling) on the card,
    bitwise the CPU's (which is bitwise jax.random.gumbel)."""
    from repro_torch.core import prng
    keys = prng.PRNGKey(torch.tensor([0, 7, 2**32 - 1]))
    want = prng.gumbel(keys, (1 << 14,))
    got = prng.gumbel(keys.to(cuda), (1 << 14,)).cpu()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# TinyLlama-1.1B's matrix leaves as the serving fold gives them (one model,
# client axis 1), cut to 2 layers: (n, m) of wq, wk/wv, w1/w3, w2
SERVE_FOLD_SHAPES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048)]


@pytest.mark.gpu
@pytest.mark.parametrize("nm", SERVE_FOLD_SHAPES,
                         ids=lambda a: "x".join(map(str, a)))
@pytest.mark.parametrize("E", [1, 2])
def test_update_kernel_at_serving_fold_shapes(cuda, nm, E):
    """The epoch update in place on W (1, 2, n, m), the unsqueezed view of
    one model's stacked leaf, against the plain version."""
    n, m = nm
    rng = np.random.default_rng(n + m + E)
    W = torch.from_numpy(_f32(rng, 2, n, m)).to(cuda).unsqueeze(0)
    U, V = (torch.from_numpy(_f32(rng, E, k, 16)).to(cuda) for k in (n, m))
    A = torch.from_numpy(_f32(rng, E, 1, 2, 16, 16) / 16).to(cuda)
    want = ops.subcge_apply_epochs(*(t.cpu() for t in (W, U, A, V)))
    build.reset_launches()
    out = ops.subcge_apply_epochs(W, U, A, V, inplace=True)
    torch.cuda.synchronize()
    assert out is W and build.LAUNCHES["subcge_apply_epochs"] == 1
    np.testing.assert_allclose(W.cpu().numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.gpu
def test_decode_server_with_live_updates_on_card_matches_cpu(cuda):
    """A DecodeServer of the reduced TinyLlama with a bridge fold at a step
    boundary, on the card and on the CPU: the same greedy tokens, folded
    weights within 1e-5, one ``subcge_apply_epochs`` launch per matrix
    leaf per fold."""
    from repro_torch.configs import archs
    from repro_torch.core.subcge import SubCGEConfig
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import subcge_meta
    from repro_torch.serve import DecodeServer, LiveUpdateBridge, Request, \
        ServeConfig
    arch = archs.reduced(archs.get("tinyllama-1.1b"))
    serve = ServeConfig(max_batch=2, page_size=4, n_pages=12, max_seq=24)
    prompts = np.random.default_rng(0).integers(0, arch.vocab, (3, 9))
    steps = np.array([0, 1, 2, 3], np.int32)

    def run(device):
        bridge = LiveUpdateBridge(arch, SubCGEConfig(rank=4, refresh_period=2),
                                  7, 0)
        params = tf.init_params(arch, 0, device)
        srv = DecodeServer(arch, params, serve, bridge=bridge, device=device)
        for rid, p in enumerate(prompts):
            srv.submit(Request(rid=rid, prompt=p, max_new=6))
        srv.step()
        bridge.ingest_arrays(steps + 11, np.full(4, 0.05, np.float32), steps)
        build.reset_launches()
        out = srv.run()
        return out, params, dict(build.LAUNCHES)

    got, p_card, launches = run(cuda)
    want, p_cpu, _ = run("cpu")
    assert got == want
    meta = subcge_meta(tf.arch_spec(arch))
    n_matrix = sum(m.is_matrix for m in meta.values())
    assert launches["subcge_apply_epochs"] == n_matrix
    for k, t in p_cpu.items():
        np.testing.assert_allclose(p_card[k].cpu().numpy(), t.numpy(),
                                   rtol=RTOL, atol=ATOL)


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


@pytest.mark.gpu
def test_selective_scan_refuses_a_gradient(cuda):
    """A scan whose inputs need a gradient is no longer refused: it goes
    through ``SelectiveScan``, whose backward is the reverse-scan kernel
    (one launch), and the gradients equal autograd of the CPU's plain
    scan."""
    rng = np.random.default_rng(9)
    B, T, D, N = 2, 11, 40, 4
    host = [torch.from_numpy(x) for x in (
        (1 / (1 + np.exp(-rng.standard_normal((B, T, D, N))))).astype(
            np.float32),
        0.1 * _f32(rng, B, T, D, N), _f32(rng, B, T, N), _f32(rng, B, D, N))]
    dy = torch.from_numpy(_f32(rng, B, T, D))
    grads = []
    for dev in (cuda, "cpu"):
        leaves = [x.to(dev).requires_grad_(True) for x in host]
        build.reset_launches()
        y, _ = ops.selective_scan(*leaves)
        grads.append(torch.autograd.grad((y * dy.to(dev)).sum(), leaves))
        if dev == cuda:
            torch.cuda.synchronize()
            assert build.LAUNCHES["selective_scan"] == 1
            assert build.LAUNCHES["selective_scan_bwd"] == 1
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=RTOL, atol=ATOL)


_CHUNK = sscan.BWD_CHUNK
# (B, T, D, N): off the 8-step prefetch and the 128-column tile, every
# state size the kernel takes, and Falcon Mamba's N = 16 at a wide D; T = 1,
# T = chunk (one chunk), chunk + 1 and 3 chunks + 5 (the checkpointed
# path, 2 and 4 chunks), and D·N = 74, whose rows are not 16-byte aligned
# (the masked copies)
SCAN_BWD_SHAPES = [(2, 7, 8, 4), (3, 37, 200, 16), (2, 9, 40, 1),
                   (1, 5, 24, 32), (2, 13, 72, 2), (1, 6, 64, 8),
                   (4, 33, 1024, 16), (3, 1, 200, 16), (2, _CHUNK, 72, 16),
                   (2, _CHUNK + 1, 72, 16), (2, 3 * _CHUNK + 5, 72, 16),
                   (2, 11, 37, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("btdn", SCAN_BWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_selective_scan_bwd_kernel_matches_plain(cuda, btdn):
    from repro_torch.kernels import selective_scan as ss
    B, T, D, N = btdn
    rng = np.random.default_rng(sum(btdn))
    host = [torch.from_numpy(x) for x in (
        (1 / (1 + np.exp(-rng.standard_normal((B, T, D, N))))).astype(
            np.float32),
        0.1 * _f32(rng, B, T, D, N), _f32(rng, B, T, N), _f32(rng, B, D, N),
        _f32(rng, B, T, D), _f32(rng, B, D, N))]
    dev = [x.to(cuda) for x in host]
    build.reset_launches()
    got = ss.selective_scan_bwd(*dev)
    again = ss.selective_scan_bwd(*dev)
    torch.cuda.synchronize()
    assert build.LAUNCHES["selective_scan_bwd"] == 2
    want = list(ss.selective_scan_bwd(*host))
    # dc is a sum over D: held against the float64 plain version, whose
    # float32 counterpart strays by more than the tolerance at large D
    want[2] = ss.selective_scan_bwd_plain(*(x.double() for x in host))[2]
    for g, a, w in zip(got, again, want):
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
        np.testing.assert_allclose(g.cpu().double().numpy(), w.numpy(),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_selective_scan_bwd_refuses_unsupported_state(cuda):
    from repro_torch.kernels import selective_scan as ss
    a = torch.zeros((1, 4, 8, 12), device=cuda)
    c, h = torch.zeros((1, 4, 12), device=cuda), torch.zeros((1, 8, 12),
                                                              device=cuda)
    build.reset_launches()
    with pytest.raises(ValueError, match="d_state"):
        ss.selective_scan_bwd(a, a, c, h, torch.zeros((1, 4, 8), device=cuda),
                              h)
    assert build.LAUNCHES["selective_scan_bwd"] == 0


@pytest.mark.gpu
def test_full_width_resume_is_bitwise(cuda, tmp_path):
    """OPT-125M whole, 8 clients on a ring, a client offline across the
    step-2 checkpoint: the resumed run ends bitwise equal to the
    uninterrupted one."""
    from repro_torch.configs import archs
    from repro_torch.dtrain.runner import DTrainConfig, run
    from repro_torch.topology.dynamic import ChurnSchedule
    base = dict(arch=archs.get("opt-125m"), n_clients=8, steps=5,
                batch_size=8, subcge_tau=2,
                churn=ChurnSchedule.leave_rejoin((3,), 1, 3), device="cuda")
    whole = run(DTrainConfig(checkpoint_every=2, checkpoint_dir=str(tmp_path),
                             **base))
    resumed = run(DTrainConfig(resume_from=str(tmp_path / "step000002.npz"),
                               **base))
    for p, w in whole.extra["final_stacked"].items():
        assert torch.equal(resumed.extra["final_stacked"][p].view(torch.int32),
                           w.view(torch.int32)), p
    assert resumed.loss_curve == whole.loss_curve
    assert resumed.total_bytes == whole.total_bytes


@pytest.mark.gpu
@pytest.mark.parametrize("trans", [False, True], ids=["plain", "trans"])
def test_rank1_kernels_read_a_shared_model(cuda, trans):
    """central_zo's dual forward: one model expanded to C clients (a client
    stride of 0), each client with its own rank-1 perturbation."""
    C, M, K, N = 5, 67, 96, 160
    x, W, u, v, s = _rank1_inputs(cuda, 21, C, M, K, N, trans)
    Ws = W[:1].contiguous().expand(C, -1, -1)
    assert Ws.stride(0) == 0
    fn = ops.rank1_matmul_t if trans else ops.rank1_matmul
    got = fn(x, Ws, u, v, s)
    want = fn(*(t.cpu() for t in (x, Ws, u, v, s)))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.gpu
def test_topk_compress_on_card_equals_cpu(cuda):
    """Choco's top-k over a whole stacked leaf, ties included."""
    from repro_torch.core import gossip
    rng = np.random.default_rng(4)
    x = torch.from_numpy((0.25 * rng.integers(-40, 41, (16, 300, 77))
                          ).astype(np.float32))
    want = gossip.topk_compress(x, 0.01)
    got = gossip.topk_compress(x.to(cuda), 0.01).cpu()
    assert torch.equal(got, want)
    assert int((want != 0).sum()) > int(x.numel() * 0.01)


# -- the bf16 paths (x, W, y and the update's W in bf16; u, v, s, U, A, V
# float32).  Tolerance: one bf16 ulp of the plain version plus atol 1e-5
# (the plain version sums in another float32 order, and a sum near a
# rounding boundary may round to the neighbouring bf16), plus, for the
# products, K/16 · 2^-23 · max |y| (the tensor cores truncate each k16
# step's float32 sum toward zero: chip_smoke.tensor_core_atol);
# and bitwise across two calls.

def _bf16_close(got, want, what="", K=0):
    g, w = got.float().cpu(), want.float().cpu()
    ulp = torch.where(w == 0, torch.zeros_like(w),
                      2.0 ** (torch.floor(torch.log2(w.abs())) - 7))
    acc = K / 16 * 2.0 ** -23 * float(w.abs().max())
    bad = (g - w).abs() > ulp + ATOL + acc
    assert not bool(bad.any()), (what, int(bad.sum()),
                                 float((g - w).abs().max()))


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


# (kind, M, K, N): N = 133 pads W's rows (not a multiple of 8); (264, 7168,
# 32) and (83, 2048, 288) split K; (67, 64, 133) transposed masks O and M;
# the expert product at a Jamba capacity; the pod's shared W at M = 2114
RANK1_BF16 = [("n", 67, 64, 133), ("n", 264, 7168, 32), ("n", 264, 1024, 1024),
              ("t", 67, 64, 133), ("t", 264, 1024, 1000),
              ("e", 83, 2048, 288), ("e", 330, 512, 136),
              ("shared", 2114, 512, 1000)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,M,K,N", RANK1_BF16,
                         ids=lambda a: str(a))
def test_rank1_bf16_kernels_match_plain(cuda, kind, M, K, N):
    if kind == "e":
        t = list(_expert_inputs(cuda, 30 + K, M, K, N))
        fn, name = ops.rank1_matmul_expert, "rank1_matmul_expert_bf16"
    else:
        C = 8 if kind == "shared" else 3
        t = list(_rank1_inputs(cuda, 30 + K, C, M, K, N, kind == "t"))
        fn = ops.rank1_matmul_t if kind == "t" else ops.rank1_matmul
        name = ("rank1_matmul_t" if kind == "t" else "rank1_matmul") + "_bf16"
    t[0], t[1] = t[0].bfloat16(), t[1].bfloat16()
    if kind == "shared":
        t[1] = t[1][:1].contiguous().expand(t[0].shape[0], -1, -1)
    build.reset_launches()
    got = fn(*t)
    again = fn(*t)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {name: 2}
    assert got.dtype == torch.bfloat16
    assert _bits_equal(got, again)
    _bf16_close(got, fn(*(a.cpu() for a in t)), name, K)


@pytest.mark.gpu
@pytest.mark.parametrize("E,n,m", [(1, 70, 150), (2, 70, 150), (1, 33, 92),
                                   (2, 300, 1000)],
                         ids=lambda a: str(a))
def test_update_bf16_kernel_matches_plain(cuda, E, n, m):
    """W bf16 in place on a strided view of stacked layers; m = 150 is not
    a multiple of 4 (plain loads), 92 and 1000 take the 8-byte copies."""
    Wst, W, U, A, V = _update_inputs(cuda, 40 + m, E, 3, 2, n, m, 16)
    Wst = (0.05 * Wst).bfloat16()
    W, other = Wst[:, 1], Wst[:, 0].cpu()
    before = W.cpu()
    want = ops.subcge_apply_epochs(before, *(a.cpu() for a in (U, A, V)))
    build.reset_launches()
    got = ops.subcge_apply_epochs(W.clone(), U, A, V)
    ops.subcge_apply_epochs(W, U, A, V, inplace=True)
    torch.cuda.synchronize()
    assert build.LAUNCHES["subcge_apply_epochs_bf16"] == 2
    assert got.dtype == W.dtype == torch.bfloat16
    assert _bits_equal(got, W)
    assert _bits_equal(Wst[:, 0].cpu(), other)
    _bf16_close(W, want, "update")
    if E == 1:
        one = ops.subcge_apply(before.to(cuda), U[0], A[0], V[0])
        assert _bits_equal(one, W)


@pytest.mark.gpu
def test_bf16_kernels_refuse_what_they_do_not_take(cuda):
    """K % 8 != 0, mixed types and a bf16 u are refused, not converted."""
    x, W, u, v, s = _rank1_inputs(cuda, 3, 2, 16, 12, 40)
    with pytest.raises(ValueError, match="K % 8"):
        ops.rank1_matmul(x.bfloat16(), W.bfloat16(), u, v, s)
    x, W, u, v, s = _rank1_inputs(cuda, 3, 2, 16, 16, 40)
    with pytest.raises(ValueError):
        ops.rank1_matmul(x.bfloat16(), W, u, v, s)
    with pytest.raises(ValueError):
        ops.rank1_matmul(x.bfloat16(), W.bfloat16(), u.bfloat16(), v, s)
    Wu = torch.zeros(4, 8, dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError):
        ops.subcge_apply(Wu, torch.zeros(4, 2, device=cuda),
                         torch.zeros(2, 2, device=cuda),
                         torch.zeros(8, 2, device=cuda))
