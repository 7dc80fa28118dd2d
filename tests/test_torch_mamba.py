"""The port's Mamba-1 path (Falcon Mamba 7B's layer) against the JAX package,
on the CPU.

Inputs come from numpy seeds, and both sides get the same weights
(``params.from_numpy``).  What is held, and how closely:

* specs (full entry as a spec only, and reduced), the reduced config field
  by field (the JAX ``chunk`` aside), initial weights, the subspaces and
  coordinates of the small matrix leaves (``conv_w``, ``A_log``, whose
  columns are fewer than the rank): exactly equal, bit for bit;
* the plain ``selective_scan`` against the JAX kernel (``jnp`` and
  ``interpret``): rtol 1e-5, atol 1e-5 on ``y`` and ``h_last`` — the same
  recurrence, the readout summed in another order;
* the reverse scan (``selective_scan_bwd_plain``, the backward kernel's
  plain version) against ``jax.vjp`` of the JAX reference scan: rtol 1e-5,
  atol 1e-6; autograd through the plain scan equals it bit for bit;
* ``_causal_conv``: rtol 1e-6, atol 1e-6 — the same products summed in the
  same order, but XLA may contract a product and its sum into one
  multiply-add;
* the Mamba layer (unperturbed and at ±ε, which covers ``matw`` and ``vec``
  on the Mamba leaves) and ``lm_loss``: rtol 1e-5, atol 1e-5 — float32
  matmuls summed in other orders, ``exp``/``log1p`` one ulp apart, and the
  sequential scan against JAX's chunked associative scan;
* a 3-step SeedFlood run on 4 clients: ledger equal, loss curve rtol 1e-4,
  final params within 1e-4 of each leaf's largest update — the ZO
  coefficient (L+ − L−) / 2ε amplifies float32 differences of the two
  forwards about 1e3-fold, so the gap scales with the update.

The JAX SeedFlood run is the file's largest cost; a module-scoped fixture
makes it once for the tests that read it.
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
from repro_torch.configs.base import AttnCfg, Group, LayerCfg, MoECfg  # noqa: E402
from repro_torch.core import subcge as tsub  # noqa: E402
from repro_torch.data.synthetic import TaskConfig  # noqa: E402
from repro_torch.dtrain.runner import DTrainConfig, run  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import selective_scan as sscan  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import params as tplib, transformer as ttf  # noqa: E402
from repro_torch.models.perturb import Bundle, epoch_subspace, sample_pert  # noqa: E402

from _torch_parity import jax_slot_bundle, subcge_pair, weights  # noqa: E402
from _torch_parity import one_thread  # noqa: E402,F401

# one torch thread per test: under pytest-xdist the intra-op pools of the
# workers wait on each other (tests/_torch_parity.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

FALCON = "falcon-mamba-7b"
RTOL = ATOL = 1e-5
EPS = 1e-3
SEEDS = np.array([12345, 4294967295], np.uint32)


def _archs(d_state=None):
    aj, at = jarchs.reduced(jarchs.get(FALCON)), tarchs.reduced(tarchs.get(FALCON))
    if d_state is None:
        return aj, at

    def widen(arch):
        slot = arch.groups[0].slots[0]
        slot = dataclasses.replace(slot, mamba=dataclasses.replace(
            slot.mamba, d_state=d_state))
        return dataclasses.replace(arch, groups=(
            dataclasses.replace(arch.groups[0], slots=(slot,)),))
    return widen(aj), widen(at)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# configuration, specs, initial weights, subspaces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_arch_spec_matches_jax(full):
    """Paths, shapes, batch dims and init of every leaf (spec only: the
    full Falcon Mamba entry is never allocated)."""
    arch_j = jarchs.get(FALCON) if full else jarchs.reduced(jarchs.get(FALCON))
    arch_t = tarchs.get(FALCON) if full else tarchs.reduced(tarchs.get(FALCON))
    assert arch_t.source == arch_j.source
    want = tplib.flatten(jtf.arch_spec(arch_j))
    got = ttf.arch_spec(arch_t)
    assert set(got) == set(want)
    for p, w in want.items():
        g = got[p]
        assert (g.shape, g.n_batch_dims, g.init, g.scale) == \
            (w.shape, w.n_batch_dims, w.init, w.scale), p
    assert tplib.n_params(got) == jtf.count_params(arch_j)
    assert "embed/out" in got and "g0/s0/ln_mlp_scale" not in got


def test_configs_match_jax_field_by_field():
    """The registry entry and ``reduced()`` carry the JAX package's values
    in every field the port has (``MambaCfg.chunk`` is left out)."""
    for arch_j, arch_t in ((jarchs.get(FALCON), tarchs.get(FALCON)), _archs()):
        for f in dataclasses.fields(arch_t):
            if f.name != "groups":
                assert getattr(arch_t, f.name) == getattr(arch_j, f.name), f.name
        assert [g.reps for g in arch_t.groups] == [g.reps for g in arch_j.groups]
        for sj, st in zip(arch_j.groups[0].slots, arch_t.groups[0].slots,
                          strict=True):
            assert (st.mixer, st.attn, st.ffn, st.d_ff, st.moe) == \
                (sj.mixer, sj.attn, sj.ffn, sj.d_ff, sj.moe)
            mj = dataclasses.asdict(sj.mamba)
            assert mj.pop("chunk") and dataclasses.asdict(st.mamba) == mj


def test_attention_without_positions_is_refused():
    arch = tarchs.get(FALCON)
    attn = LayerCfg(mixer="attn", attn=AttnCfg(2, 2, 32), ffn="dense", d_ff=8)
    mixed = dataclasses.replace(arch, groups=(Group((attn,), 1),))
    with pytest.raises(NotImplementedError, match="without positions"):
        ttf.arch_spec(mixed)
    # a Mamba slot may take an FFN (Jamba), but the MoE's experts are gated
    # silu: one after a Mamba slot of a plain-MLP model is refused
    moe = MoECfg(n_experts=4, top_k=2, d_ff_expert=64)
    with pytest.raises(NotImplementedError):
        ttf.arch_spec(dataclasses.replace(arch, gated_mlp=False, groups=(
            Group((dataclasses.replace(arch.groups[0].slots[0], ffn="moe",
                                       moe=moe),), 1),)))


@pytest.mark.parametrize("d_state", [4, 16])
def test_init_params_bitwise(d_state):
    """Every leaf, ``A_log`` (log 1..N through XLA's float32 log; at N = 16
    ``torch.log`` differs in one value), ``dt_bias`` and ``D_skip``
    included."""
    arch_j, arch_t = _archs(d_state)
    want = tplib.flatten(jax.tree.map(np.asarray, jtf.init_params(arch_j, 5)))
    got = ttf.init_params(arch_t, 5)
    assert set(got) == set(want)
    assert got["g0/s0/A_log"].shape == (1, 128, d_state)
    for p, w in want.items():
        assert (_bits(got[p].numpy()) == _bits(w)).all(), p
    assert float(got["g0/s0/D_skip"].min()) == 1.0


@pytest.mark.parametrize("rank", [4, 16])
def test_small_matrix_subspaces_and_coords_bitwise(rank):
    """conv_w (Di, 4) and A_log (Di, 4) at a rank up to four times their
    columns: the port's subspaces and coordinates are the JAX package's."""
    arch_j, arch_t = _archs()
    meta_j, meta_t, cfg_j, cfg_t = subcge_pair(arch_j, arch_t, EPS, rank)
    sub_j = jsub.subspace_at_step(meta_j, cfg_j, 7, 5)
    sub_t = tsub.subspace_at_step(meta_t, cfg_t, 7, 5)
    assert set(sub_j) == set(sub_t)
    for p in ("g0/s0/conv_w", "g0/s0/A_log", "g0/s0/x_proj", "g0/s0/dt_proj"):
        assert sub_t[p][1].shape[1] == rank
        assert (_bits(sub_j[p].U) == _bits(sub_t[p][0].numpy())).all(), p
        assert (_bits(sub_j[p].V) == _bits(sub_t[p][1].numpy())).all(), p
    seeds = np.array([0, 65536, 4294967295, 777], np.uint32)
    coords = tsub.sample_coords(meta_t, cfg_t,
                                torch.as_tensor(seeds.astype(np.int64)))
    for k, s in enumerate(seeds):
        for p, ij in jsub.sample_coords(meta_j, cfg_j, s).items():
            assert (np.asarray(ij.i) == coords[p][0][k].numpy()).all(), p
            assert (np.asarray(ij.j) == coords[p][1][k].numpy()).all(), p


# ---------------------------------------------------------------------------
# the kernel's plain version and the layer
# ---------------------------------------------------------------------------

def _scan_inputs(B, T, D, N, seed):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, D, N))))
    bx = 0.1 * rng.standard_normal((B, T, D, N))
    c = rng.standard_normal((B, T, N))
    h0 = rng.standard_normal((B, D, N))
    return [x.astype(np.float32) for x in (a, bx, c, h0)]


@pytest.mark.parametrize("backend", ["jnp", "interpret"])
@pytest.mark.parametrize("btdn", [(1, 64, 128, 16), (2, 128, 128, 8),
                                  (1, 96, 256, 4), (3, 33, 64, 16)])
def test_selective_scan_plain_matches_jax(btdn, backend):
    inputs = _scan_inputs(*btdn, seed=sum(btdn))
    y, h = ops.selective_scan(*(torch.from_numpy(x) for x in inputs))
    want_y, want_h = jops.selective_scan(*(jnp.asarray(x) for x in inputs),
                                         backend=backend)
    assert y.shape == btdn[:3] and h.shape == (btdn[0],) + btdn[2:]
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("btdn", [(2, 7, 8, 4), (3, 33, 64, 16)])
def test_selective_scan_bwd_plain_matches_jax_vjp(btdn):
    """The reverse scan written out (the plain version of the backward
    kernel) against ``jax.vjp`` of the JAX reference scan, with cotangents
    on both y and h_last; and autograd through the CPU path's plain scan
    against it."""
    B, T, D, N = btdn
    inputs = _scan_inputs(*btdn, seed=7 * sum(btdn))
    rng = np.random.default_rng(sum(btdn))
    dy = rng.standard_normal((B, T, D)).astype(np.float32)
    dh = rng.standard_normal((B, D, N)).astype(np.float32)
    _, vjp = jax.vjp(lambda *x: jops.selective_scan(*x, backend="jnp"),
                     *(jnp.asarray(x) for x in inputs))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    t_in = [torch.from_numpy(x) for x in inputs]
    got = sscan.selective_scan_bwd_plain(*t_in, torch.from_numpy(dy),
                                         torch.from_numpy(dh))
    leaves = [x.clone().requires_grad_(True) for x in t_in]
    y, h = ops.selective_scan(*leaves)
    auto = torch.autograd.grad(
        (y * torch.from_numpy(dy)).sum() + (h * torch.from_numpy(dh)).sum(),
        leaves)
    for name, g, w, a in zip(("da", "dbx", "dc", "dh0"), got, want, auto):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        assert torch.equal(a, g), name


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(4)
    C, B, T, Di, Kc = 2, 3, 33, 16, 4
    x = rng.standard_normal((C, B, T, Di)).astype(np.float32)
    w = rng.standard_normal((C, Di, Kc)).astype(np.float32)
    bias = rng.standard_normal((C, Di)).astype(np.float32)
    got = tlayers._causal_conv(*(torch.from_numpy(a) for a in (x, w, bias)))
    for c in range(C):
        want = jlayers._causal_conv(jnp.asarray(x[c]), jnp.asarray(w[c]),
                                    jnp.asarray(bias[c]))
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scale", [None, EPS, -EPS])
def test_mamba_layer_matches_jax(scale):
    arch_j, arch_t = _archs()
    mj, mt = arch_j.groups[0].slots[0].mamba, arch_t.groups[0].slots[0].mamba
    meta_j, meta_t, cfg_j, cfg_t = subcge_pair(arch_j, arch_t, EPS)
    C = len(SEEDS)
    trees, stacked = weights(arch_j, C)
    x = np.random.default_rng(3).standard_normal(
        (C, 2, 33, arch_j.d_model)).astype(np.float32)
    if scale is None:
        b = Bundle(stacked, None, None, "g0/s0/", 0)
    else:
        pert = sample_pert(meta_t, cfg_t,
                           torch.as_tensor(SEEDS.astype(np.int64)), scale)
        b = Bundle(stacked, epoch_subspace(meta_t, cfg_t, 5, 4), pert,
                   "g0/s0/", 0)
        base = Bundle(stacked, None, None, "g0/s0/", 0)
        for k in ("conv_w", "A_log"):
            assert not torch.equal(b.matw(k), base.matw(k))
    y = tlayers.mamba(b, torch.from_numpy(x), mt)
    assert y.shape == x.shape

    sub_j = jepoch_subspace(meta_j, cfg_j, 5, 4)
    for c in range(C):
        jb = jax_slot_bundle(trees[c], meta_j, cfg_j, sub_j,
                              None if scale is None else SEEDS[c], scale)
        yj, cache = jlayers.mamba(jb, jnp.asarray(x[c]), mj, None)
        assert cache is None
        np.testing.assert_allclose(y[c].numpy(), np.asarray(yj), rtol=RTOL,
                                   atol=ATOL)


def test_lm_loss_matches_jax():
    arch_j, arch_t = _archs()
    meta_j, meta_t, cfg_j, cfg_t = subcge_pair(arch_j, arch_t, EPS)
    C = len(SEEDS)
    trees, stacked = weights(arch_j, C, seed=4)
    toks = np.random.default_rng(1).integers(0, arch_j.vocab, (C, 2, 33),
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
                                       rtol=RTOL, atol=ATOL)
    assert float(got[EPS][0]) != float(got[-EPS][0])


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------

RUN = dict(n_clients=4, steps=3, batch_size=2)
TASK = dict(vocab=256, n_valid=8, n_test=64)


@pytest.fixture(scope="module")
def runs():
    """The JAX package's and the port's 3-step SeedFlood runs on reduced
    Falcon Mamba (the JAX run dominates this file's time)."""
    arch_j, arch_t = _archs()
    rj = jrun(JConfig(arch=arch_j, task=JTask(**TASK), **RUN))
    rt = run(DTrainConfig(arch=arch_t, task=TaskConfig(**TASK), device="cpu",
                          **RUN))
    return arch_j, rj, rt


def test_seedflood_run_ledger_and_losses_match_jax(runs):
    _, rj, rt = runs
    assert (rt.extra["n_messages"], rt.total_bytes, rt.bytes_per_edge) == \
        (rj.extra["n_messages"], rj.total_bytes, rj.bytes_per_edge)
    np.testing.assert_allclose(rt.loss_curve, rj.loss_curve, rtol=1e-4)
    assert rt.consensus_error < 1e-10


def test_seedflood_run_params_match_jax(runs):
    arch_j, rj, rt = runs
    want = tplib.flatten(jax.tree.map(np.asarray, rj.extra["final_stacked"]))
    init = tplib.flatten(jax.tree.map(np.asarray, jtf.init_params(arch_j, 0)))
    got = rt.extra["final_stacked"]
    assert set(got) == set(want)
    for p, w in want.items():
        update = float(np.abs(w - init[p][None]).max())
        assert update > 0, p
        np.testing.assert_allclose(got[p].numpy(), w, rtol=0,
                                   atol=1e-4 * update, err_msg=p)
