"""The port's MoE path (Kimi K2's layer) against the JAX package, on the CPU.

Inputs come from numpy seeds, and both sides get the same weights
(``params.from_numpy``).  What is held, and how closely:

* specs, ``(L, E)`` coordinates, routing (``top_i``), dispatch positions,
  the keep mask and the drop pattern: exactly equal.  Routing is a discrete
  choice: a float32 difference that flips a near-tie in ``top_k`` changes
  the loss by far more than any tolerance, so the router's choices must
  agree on these inputs, not merely its probabilities;
* ``rank1_matmul_expert``'s plain version against the JAX kernel (``jnp``
  and ``interpret``), the MoE output and ``lm_loss``: rtol 1e-5, atol 1e-5
  (aux: rtol 1e-5) — float32 products summed in different orders;
* a 3-step SeedFlood run on 4 clients: ledger equal, loss curve rtol 1e-4,
  final params within 1e-4 of each leaf's largest update — the ZO
  coefficient (L+ − L−) / 2ε amplifies float32 summation-order differences
  of the two forwards about 1e3-fold, and at this size three steps move
  weights by up to ~1.2, so the gap scales with the update, not with the
  weights (measured: 2.4e-5 to 4.4e-5 of the update, per leaf).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.core import subcge as jsub  # noqa: E402
from repro.data.synthetic import TaskConfig as JTask  # noqa: E402
from repro.dtrain.runner import DTrainConfig as JConfig, run as jrun  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.perturb import epoch_subspace as jepoch_subspace  # noqa: E402
from repro.models.perturb import sample_pert as jsample_pert  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.core import subcge as tsub  # noqa: E402
from repro_torch.data.synthetic import TaskConfig  # noqa: E402
from repro_torch.dtrain.runner import DTrainConfig, run  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import params as tplib, transformer as ttf  # noqa: E402
from repro_torch.models.perturb import Bundle, epoch_subspace, sample_pert  # noqa: E402

from _torch_parity import jax_slot_bundle, subcge_pair, weights  # noqa: E402
from _torch_parity import one_thread  # noqa: E402,F401

# one torch thread per test: under pytest-xdist the intra-op pools of the
# workers wait on each other (tests/_torch_parity.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

KIMI = "kimi-k2-1t-a32b"
RTOL = ATOL = 1e-5
EPS = 1e-3
SEEDS = np.array([12345, 4294967295], np.uint32)


def _archs():
    return jarchs.reduced(jarchs.get(KIMI)), tarchs.reduced(tarchs.get(KIMI))


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_arch_spec_matches_jax(full):
    """Paths, shapes, batch dims and init of every leaf (spec only: the
    full Kimi K2 entry is never allocated)."""
    arch_j = jarchs.get(KIMI) if full else jarchs.reduced(jarchs.get(KIMI))
    arch_t = tarchs.get(KIMI) if full else tarchs.reduced(tarchs.get(KIMI))
    assert arch_t.source == arch_j.source
    want = tplib.flatten(jtf.arch_spec(arch_j))
    got = ttf.arch_spec(arch_t)
    assert set(got) == set(want)
    for p, w in want.items():
        g = got[p]
        assert (g.shape, g.n_batch_dims, g.init, g.scale) == \
            (w.shape, w.n_batch_dims, w.init, w.scale), p
    assert tplib.n_params(got) == jtf.count_params(arch_j)
    assert got["g0/s0/w1"].n_batch_dims == 2 and "embed/out" in got


def test_init_params_bitwise_and_numpy_round_trip():
    """Expert leaves (reps, E, n, m) draw the JAX package's weights bit for
    bit, and ``to_numpy`` / ``from_numpy`` carry them unchanged."""
    arch_j, arch_t = _archs()
    want = tplib.flatten(jax.tree.map(np.asarray, jtf.init_params(arch_j, 5)))
    got = ttf.init_params(arch_t, 5)
    assert set(got) == set(want) and got["g0/s0/w3"].shape == (1, 4, 64, 128)
    for p, w in want.items():
        assert (got[p].numpy().view(np.int32) == w.view(np.int32)).all(), p
    back = tplib.from_numpy(tplib.to_numpy(got))
    assert all(torch.equal(back[p], got[p]) for p in got)


def test_expert_coordinates_are_bitwise():
    arch_j, arch_t = _archs()
    meta_j, meta_t, cfg_j, cfg_t = subcge_pair(arch_j, arch_t, EPS)
    seeds = np.array([0, 65536, 4294967295, 777], np.uint32)
    # K = 2 messages per client, as the replay samples them: (C, K, L, E)
    st = torch.as_tensor(seeds.astype(np.int64)).reshape(2, 2)
    coords = tsub.sample_coords(meta_t, cfg_t, st)
    assert coords["g0/s0/w2"][0].shape == (2, 2, 1, 4)
    for k, s in enumerate(seeds):
        for p, ij in jsub.sample_coords(meta_j, cfg_j, s).items():
            for a, b in ((ij.i, coords[p][0]), (ij.j, coords[p][1])):
                assert (np.asarray(a) == b.reshape((4,) + b.shape[2:])[k]
                        .numpy()).all(), p


@pytest.mark.parametrize("backend", ["jnp", "interpret"])
def test_rank1_matmul_expert_plain_matches_jax(backend):
    rng = np.random.default_rng(11)
    C, E, M, K, N = 2, 3, 10, 16, 24
    x, W = (rng.standard_normal(s).astype(np.float32)
            for s in ((C, E, M, K), (C, E, K, N)))
    u, v = (rng.standard_normal(s).astype(np.float32)
            for s in ((C, E, K), (C, E, N)))
    s = np.array([1e-3, -0.5], np.float32)
    got = ops.rank1_matmul_expert(*(torch.from_numpy(a)
                                    for a in (x, W, u, v, s))).numpy()
    for c in range(C):
        want = np.asarray(jops.rank1_matmul_expert(
            x[c], W[c], u[c].T, v[c].T, s[c], backend=backend))
        np.testing.assert_allclose(got[c], want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["no-drops", "drops"])
@pytest.mark.parametrize("scale", [None, EPS, -EPS])
def test_moe_matches_jax(cf, scale):
    arch_j, arch_t = _archs()
    mj = dataclasses.replace(arch_j.groups[0].slots[0].moe, capacity_factor=cf)
    mt = dataclasses.replace(arch_t.groups[0].slots[0].moe, capacity_factor=cf)
    meta_j, meta_t, cfg_j, cfg_t = subcge_pair(arch_j, arch_t, EPS)
    C = len(SEEDS)
    trees, stacked = weights(arch_j, C)
    x = np.random.default_rng(3).standard_normal(
        (C, 2, 9, arch_j.d_model)).astype(np.float32)
    if scale is None:
        b = Bundle(stacked, None, None, "g0/s0/", 0)
    else:
        pert = sample_pert(meta_t, cfg_t, torch.as_tensor(SEEDS.astype(np.int64)),
                           scale)
        b = Bundle(stacked, epoch_subspace(meta_t, cfg_t, 5, 4), pert,
                   "g0/s0/", 0)
    xt = torch.from_numpy(x)
    y, aux = tlayers.moe(b, xt, mt)
    _, _, top_i = tlayers.route(b, xt.reshape(C, 18, -1), mt)
    cap = max(1, int(np.ceil(18 * mt.top_k / mt.n_experts * cf)))
    pos, keep = tlayers._dispatch_indices(top_i, mt.n_experts, cap)
    assert bool(keep.all()) == (cf == 8.0)

    sub_j = jepoch_subspace(meta_j, cfg_j, 5, 4)
    for c in range(C):
        jb = jax_slot_bundle(trees[c], meta_j, cfg_j, sub_j,
                              None if scale is None else SEEDS[c], scale)
        xc = jnp.asarray(x[c])
        probs = jax.nn.softmax(jb.dense("router", xc.reshape(18, -1))
                               .astype(jnp.float32), axis=-1)
        _, ti = jax.lax.top_k(probs, mj.top_k)
        pj, kj = jlayers._dispatch_indices(ti, mj.n_experts, cap)
        assert (np.asarray(ti) == top_i[c].numpy()).all()
        assert (np.asarray(pj) == pos[c].numpy()).all()
        assert (np.asarray(kj) == keep[c].numpy()).all()
        yj, auxj = jlayers.moe(jb, xc, mj, "silu", True)
        np.testing.assert_allclose(y[c].numpy(), np.asarray(yj), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(float(aux[c]), float(auxj), rtol=RTOL)


def test_lm_loss_untied_head_matches_jax():
    arch_j, arch_t = _archs()
    assert not arch_t.tie_embeddings
    meta_j, meta_t, cfg_j, cfg_t = subcge_pair(arch_j, arch_t, EPS)
    C = len(SEEDS)
    trees, stacked = weights(arch_j, C, seed=4)
    toks = np.random.default_rng(1).integers(0, arch_j.vocab, (C, 2, 9),
                                             dtype=np.int32)
    sub_t = epoch_subspace(meta_t, cfg_t, 5, 4)
    pert_t = sample_pert(meta_t, cfg_t, torch.as_tensor(SEEDS.astype(np.int64)),
                         EPS)
    tt = torch.as_tensor(toks)
    got = {None: ttf.lm_loss(arch_t, stacked, tt),
           EPS: ttf.lm_loss(arch_t, stacked, tt, sub=sub_t, pert=pert_t),
           -EPS: ttf.lm_loss(arch_t, stacked, tt, sub=sub_t,
                             pert=pert_t.with_scale(-EPS))}
    sub_j = jepoch_subspace(meta_j, cfg_j, 5, 4)

    @jax.jit
    def loss_j(p, tk, seed, scale):
        pert = jsample_pert(meta_j, cfg_j, seed, scale)
        return jtf.lm_loss(arch_j, p, {"tokens": tk}, sub=sub_j, pert=pert,
                           kernel_backend="jnp")

    plain = jax.jit(lambda p, tk: jtf.lm_loss(arch_j, p, {"tokens": tk}))
    for c in range(C):
        tk = jnp.asarray(toks[c])
        want = {None: plain(trees[c], tk),
                EPS: loss_j(trees[c], tk, SEEDS[c], EPS),
                -EPS: loss_j(trees[c], tk, SEEDS[c], -EPS)}
        for sign, w in want.items():
            np.testing.assert_allclose(float(got[sign][c]), float(w),
                                       rtol=RTOL)
    assert float(got[EPS][0]) != float(got[-EPS][0])


def test_seedflood_run_matches_jax():
    arch_j, arch_t = _archs()
    kw = dict(n_clients=4, steps=3, batch_size=2)
    task = dict(vocab=256, n_valid=8, n_test=64)
    rj = jrun(JConfig(arch=arch_j, task=JTask(**task), **kw))
    rt = run(DTrainConfig(arch=arch_t, task=TaskConfig(**task), device="cpu",
                          **kw))
    assert (rt.extra["n_messages"], rt.total_bytes) == \
        (rj.extra["n_messages"], rj.total_bytes)
    np.testing.assert_allclose(rt.loss_curve, rj.loss_curve, rtol=1e-4)
    assert rt.consensus_error < 1e-10
    want = tplib.flatten(jax.tree.map(np.asarray, rj.extra["final_stacked"]))
    init = tplib.flatten(jax.tree.map(np.asarray, jtf.init_params(arch_j, 0)))
    got = rt.extra["final_stacked"]
    assert set(got) == set(want)
    for p, w in want.items():
        update = float(np.abs(w - init[p][None]).max())
        np.testing.assert_allclose(got[p].numpy(), w, rtol=0,
                                   atol=1e-4 * update, err_msg=p)
