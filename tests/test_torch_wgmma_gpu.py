"""The bf16 rank-1 products (``rank1_gemm_bf16``: wgmma fed by a TMA ring)
against their plain PyTorch versions, on a card.

Every test carries the ``gpu`` marker and skips without a CUDA device.  No
JAX here, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_wgmma_gpu.py

Tolerance, as phase 2 of ``chip_smoke.py`` holds these products: one bf16
ulp of the plain version plus atol 1e-5 plus K/16 · 2^-23 · max |y| (the
tensor cores' float32 sums of each k16 step, ``tensor_core_atol``); and
bitwise equal across two calls.  The cases cover M off the 64-row
warpgroup tile, a folded row tile that straddles two clients, N % 8 != 0
(the padded W), K off the 64-k slab, split K, the transposed product,
experts on a strided W, and a shared W (client stride 0) folded, not
folded, and beside unshared Ws.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import rank1_matmul as r1  # noqa: E402

ATOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, K, what):
    g, w = got.float(), want.float()
    ulp = torch.where(w == 0, torch.zeros_like(w),
                      2.0 ** (torch.floor(torch.log2(w.abs())) - 7))
    acc = K / 16 * 2.0 ** -23 * float(w.abs().max())
    bad = (g - w).abs() > ulp + ATOL + acc
    assert not bool(bad.any()), (what, int(bad.sum()),
                                 float((g - w).abs().max()))


def _bits(t):
    return t.view(torch.int16)


def _inputs(cuda, seed, C, M, K, N, *, trans=False, shared=False,
            x_gap=False, experts=0):
    """bf16 x and W, float32 u, v, s.  W: a strided view of stacked (C, 2,
    ...) params at layer 1, or one W expanded with a client stride of 0
    (``shared``); experts: x (C, E, M, K), W the (C, E, K, N) view of
    stacked (C, 2, E, K, N).  ``x_gap``: x a view with a client stride of
    2 M K (not contiguous over (C, M)).  W and the contracted vector are
    scaled by K^-1/2."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(cuda)
    lead = (C, experts) if experts else (C,)
    x = f(C, 2, *lead[1:], M, K).bfloat16()[:, 1] if x_gap \
        else f(*lead, M, K).bfloat16()
    wshape = (N, K) if trans else (K, N)
    if shared:
        W = f(1, *wshape, scale=K ** -0.5).bfloat16().expand(C, *wshape)
    else:
        W = f(C, 2, *lead[1:], *wshape, scale=K ** -0.5).bfloat16()[:, 1]
    cvec = f(*lead, K, scale=K ** -0.5)
    ovec = f(*lead, N)
    u, v = (ovec, cvec) if trans else (cvec, ovec)
    s = torch.tensor(np.resize(np.array([1e-3, -1e-3, 0.5], np.float32), C),
                     device=cuda)
    return x, W, u, v, s


# (kind, C, M, K, N, options): M = 67 and 83 off the 64-row warpgroup tile;
# folded rows of 67 and 2114 a client straddle row tiles of 128; N = 133
# pads W; K = 200 and 520 end inside a 64-k slab; (8, 33 or 32, 4096, 40)
# folded and (C 2 x E 3, 83, 2048, 288) split K; "t" transposed; experts on
# the strided W; a shared W not folded (x_gap) and unshared Ws.  Clusters
# of two CTAs (``cluster_of``: an even or large count of row tiles) at
# (3, 67) and 2114 folded, (8, 32) folded and split, (4, 256) transposed,
# the 256-row experts; one CTA elsewhere.
BF16_CASES = [
    ("n", 3, 67, 200, 133, {}),
    ("n", 3, 67, 136, 264, {"shared": True}),
    ("n", 8, 2114, 512, 1000, {"shared": True}),
    ("n", 8, 33, 4096, 40, {"shared": True}),
    ("n", 8, 32, 4096, 40, {"shared": True}),
    ("n", 3, 67, 136, 264, {"shared": True, "x_gap": True}),
    ("t", 3, 67, 520, 1000, {}),
    ("t", 8, 264, 1024, 1000, {"shared": True}),
    ("t", 4, 256, 1024, 1000, {"shared": True}),
    ("e", 2, 83, 2048, 288, {"experts": 3}),
    ("e", 2, 330, 512, 136, {"experts": 3, "x_gap": True}),
    ("e", 2, 256, 512, 136, {"experts": 3}),
]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,C,M,K,N,opt", BF16_CASES,
                         ids=lambda a: str(a))
def test_bf16_products_match_plain(cuda, kind, C, M, K, N, opt):
    x, W, u, v, s = _inputs(cuda, 7 + K + N, C, M, K, N,
                            trans=kind == "t", **opt)
    fn = {"n": ops.rank1_matmul, "t": ops.rank1_matmul_t,
          "e": ops.rank1_matmul_expert}[kind]
    name = {"n": "rank1_matmul", "t": "rank1_matmul_t",
            "e": "rank1_matmul_expert"}[kind] + "_bf16"
    E = opt.get("experts", 1)
    fold = r1.folds(C, E, M, K, x.stride(0), W.stride(0))
    assert fold == (opt.get("shared", False) and not opt.get("x_gap")
                    and kind != "e")
    splits, kper = r1.gemm_plan(C, E, M, N, K, bf16=True, fold=fold)
    build.reset_launches()
    got = fn(x, W, u, v, s)
    again = fn(x, W, u, v, s)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {name: 2}
    assert got.dtype == torch.bfloat16 and torch.equal(_bits(got),
                                                       _bits(again))
    plain = {"n": r1.rank1_matmul_plain, "t": r1.rank1_matmul_t_plain,
             "e": r1.rank1_matmul_expert_plain}[kind]
    _close(got, plain(x, W, u, v, s), K, (kind, C, M, K, N, opt, splits))
