"""The OPT family (the paper's own models) in the port, against the JAX
package: layernorm, learned positions, a plain relu MLP and QKV bias.

* ``arch_spec``: the same leaf paths and shapes (at full width the spec
  only, no weights drawn); ``init_params`` bitwise at the reduced size;
* ``layernorm`` alone: atol 1e-6 (float32 mean and variance, summed in
  other orders);
* ``lm_loss`` without a perturbation and at ±ε on the same weights: rtol
  1e-5, the tolerance ``test_torch_model.py`` holds the reduced Qwen to;
* one SeedFlood run at the paper's setting, narrowed: a d32 OPT, 64
  clients on the 8 x 8 mesh-grid, the bitset flood engine picked by
  ``flood_backend="auto"`` on both sides.  Bytes and messages equal;
  losses and ``valid_loss`` rtol 1e-4; final params atol 3e-5 (the
  finite-difference coefficient turns float32 rounding of the forwards
  into ~1e-3 relative coefficient differences, as in test_torch_slice);
  consensus inside the port < 1e-10.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.data.synthetic import TaskConfig as JTask  # noqa: E402
from repro.dtrain.api import Setup as JSetup  # noqa: E402
from repro.dtrain.runner import DTrainConfig as JConfig, run as jrun  # noqa: E402
from repro.models import layers as jL, transformer as jtf  # noqa: E402
from repro.models.perturb import epoch_subspace as jepoch_subspace  # noqa: E402
from repro.models.perturb import sample_pert as jsample_pert  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.configs.base import MoECfg  # noqa: E402
from repro_torch.data.synthetic import TaskConfig  # noqa: E402
from repro_torch.dtrain.runner import DTrainConfig, run  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import params as tplib, transformer as ttf  # noqa: E402
from repro_torch.models.perturb import epoch_subspace, sample_pert  # noqa: E402

from _torch_parity import one_thread, subcge_pair, weights  # noqa: E402,F401

EPS = 1e-3
SEEDS = np.array([12345, 4294967295], np.uint32)
OPT = ["opt-125m", "opt-1.3b", "opt-2.7b"]


def _reduced(d_model=64):
    return (jarchs.reduced(jarchs.get("opt-125m"), d_model=d_model),
            tarchs.reduced(tarchs.get("opt-125m"), d_model=d_model))


@pytest.mark.parametrize("name", OPT)
def test_registry_entry_matches_jax(name):
    arch_j, arch_t = jarchs.get(name), tarchs.get(name)
    for f in dataclasses.fields(arch_t):
        if f.name != "groups":
            assert getattr(arch_t, f.name) == getattr(arch_j, f.name), f.name
    (gj,), (gt,) = arch_j.groups, arch_t.groups
    (sj,), (st,) = gj.slots, gt.slots
    assert gt.reps == gj.reps
    assert (st.mixer, st.ffn, st.d_ff) == (sj.mixer, sj.ffn, sj.d_ff)
    assert dataclasses.astuple(st.attn) == \
        dataclasses.astuple(sj.attn)[:len(dataclasses.astuple(st.attn))]


@pytest.mark.parametrize("name", OPT + ["reduced"])
def test_arch_spec_matches_jax(name):
    if name == "reduced":
        arch_j, arch_t = _reduced()
    else:
        arch_j, arch_t = jarchs.get(name), tarchs.get(name)
    want = tplib.flatten(jtf.arch_spec(arch_j))
    got = ttf.arch_spec(arch_t)
    assert set(got) == set(want)
    for p, s in want.items():
        assert (got[p].shape, got[p].n_batch_dims, got[p].init, got[p].scale) \
            == (tuple(s.shape), s.n_batch_dims, s.init, s.scale), p


def test_opt_125m_spec_at_full_width():
    """17 leaves: 8 matrices (tok, pos, wq, wk, wv, wo, w1, w2) and 9
    vectors; 126,755,328 parameters, as the JAX package counts them."""
    spec = ttf.arch_spec(tarchs.get("opt-125m"))
    mats = sorted(p.split("/")[-1] for p, s in spec.items()
                  if len(s.shape) - s.n_batch_dims == 2)
    assert len(spec) == 17
    assert mats == ["pos", "tok", "w1", "w2", "wk", "wo", "wq", "wv"]
    assert spec["embed/pos"].shape == (ttf.LEARNED_POS_LEN, 768)
    assert tplib.n_params(spec) == 126_755_328 == \
        jtf.count_params(jarchs.get("opt-125m"))


def test_init_params_bitwise():
    arch_j, arch_t = _reduced()
    want = tplib.flatten(jax.tree.map(np.asarray, jtf.init_params(arch_j, 4)))
    got = ttf.init_params(arch_t, 4)
    assert set(got) == set(want)
    for p, w in want.items():
        assert (got[p].numpy().view(np.int32) == w.view(np.int32)).all(), p
    # the norm biases and scales start at zero, the tables are scaled 0.02
    assert float(got["g0/s0/ln_attn_bias"].abs().max()) == 0.0
    assert 0 < float(got["embed/pos"].std()) < 0.03


def test_layernorm_matches_jax():
    rng = np.random.default_rng(7)
    x = (3.0 * rng.standard_normal((2, 3, 5, 64)) + 1.5).astype(np.float32)
    scale = (0.1 * rng.standard_normal((2, 64))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((2, 64))).astype(np.float32)
    got = tL.layernorm(torch.as_tensor(x), torch.as_tensor(scale),
                       torch.as_tensor(bias)).numpy()
    for c in range(2):
        want = np.asarray(jL.layernorm(jnp.asarray(x[c]), jnp.asarray(scale[c]),
                                       jnp.asarray(bias[c])))
        np.testing.assert_allclose(got[c], want, rtol=0, atol=1e-6)


def test_lm_loss_matches_jax():
    arch_j, arch_t = _reduced()
    C = len(SEEDS)
    trees, stacked = weights(arch_j, C)
    toks = np.random.default_rng(1).integers(0, arch_j.vocab, (C, 2, 9),
                                             dtype=np.int32)
    meta_j, meta_t, cfg_j, cfg_t = subcge_pair(arch_j, arch_t, EPS)
    assert "embed/pos" in meta_t and meta_t["embed/pos"].is_matrix
    sub_t = epoch_subspace(meta_t, cfg_t, 5, 4)
    pert_t = sample_pert(meta_t, cfg_t, torch.as_tensor(SEEDS.astype(np.int64)),
                         EPS)
    tt = torch.as_tensor(toks)
    got = {None: ttf.lm_loss(arch_t, stacked, tt),
           EPS: ttf.lm_loss(arch_t, stacked, tt, sub=sub_t, pert=pert_t),
           -EPS: ttf.lm_loss(arch_t, stacked, tt, sub=sub_t,
                             pert=pert_t.with_scale(-EPS))}

    sub_j = jepoch_subspace(meta_j, cfg_j, 5, 4)
    plain = jax.jit(lambda p, tk: jtf.lm_loss(arch_j, p, {"tokens": tk}))

    @jax.jit
    def perturbed(p, tk, seed, scale):
        pert = jsample_pert(meta_j, cfg_j, seed, scale)
        return jtf.lm_loss(arch_j, p, {"tokens": tk}, sub=sub_j, pert=pert,
                           kernel_backend="jnp")

    for c in range(C):
        tk = jnp.asarray(toks[c])
        want = {None: plain(trees[c], tk),
                EPS: perturbed(trees[c], tk, SEEDS[c], EPS),
                -EPS: perturbed(trees[c], tk, SEEDS[c], -EPS)}
        for sign, w in want.items():
            np.testing.assert_allclose(float(got[sign][c]), float(w),
                                       rtol=1e-5)
    assert float(got[EPS][0]) != float(got[-EPS][0])


@pytest.mark.usefixtures("one_thread")
def test_seedflood_run_matches_jax():
    kw = dict(n_clients=64, topology="meshgrid", flood_backend="auto",
              steps=2, batch_size=1)
    task = dict(vocab=256, n_valid=8, n_test=64)
    arch_j, arch_t = _reduced(d_model=32)
    jcfg = JConfig(arch=arch_j, task=JTask(**task), **kw)
    rj = jrun(jcfg)
    rt = run(DTrainConfig(arch=arch_t, task=TaskConfig(**task), device="cpu",
                          **kw))
    assert rt.extra["engine"] == "VectorFloodNetwork"
    assert rt.total_bytes == rj.total_bytes
    assert rt.extra["n_messages"] == rj.extra["n_messages"]
    np.testing.assert_allclose(rt.loss_curve, rj.loss_curve, rtol=1e-4)
    assert rt.consensus_error < 1e-10
    want = tplib.flatten(jax.tree.map(np.asarray, rj.extra["final_stacked"]))
    got = rt.extra["final_stacked"]
    assert set(got) == set(want)
    for p, w in want.items():
        np.testing.assert_allclose(got[p].numpy(), w, atol=3e-5, err_msg=p)
    np.testing.assert_allclose(
        rt.extra["valid_loss"],
        JSetup(jcfg).valid_loss(rj.extra["final_stacked"]), rtol=1e-4)


def _mamba_then_ffn():
    """A Mamba slot followed by an MoE (Jamba's odd slots) in OPT-125M's
    plain relu model: a Mamba slot may take an FFN, but the MoE's experts
    are gated silu, so ``_slot_ok`` refuses it."""
    falcon = tarchs.get("falcon-mamba-7b")
    (slot,) = falcon.groups[0].slots
    moe = MoECfg(n_experts=4, top_k=2, d_ff_expert=2 * falcon.d_model)
    return dict(groups=(dataclasses.replace(
        falcon.groups[0], slots=(dataclasses.replace(
            slot, ffn="moe", moe=moe),)),))


# the "sinusoidal" case keeps its id: the port took sinusoidal positions
# with MusicGen-medium, and the case now holds a position kind that
# neither package implements
@pytest.mark.parametrize("change", [_mamba_then_ffn(), dict(pos="alibi"),
                                    dict(norm="nonorm")],
                         ids=["mamba-ffn", "sinusoidal", "norm"])
def test_unported_settings_are_refused(change):
    arch = dataclasses.replace(tarchs.get("opt-125m"), **change)
    with pytest.raises(NotImplementedError):
        ttf.arch_spec(arch)


def test_moe_experts_stay_gated_silu():
    kimi = tarchs.reduced(tarchs.get("kimi-k2-1t-a32b"))
    for change in (dict(act="relu"), dict(gated_mlp=False)):
        with pytest.raises(NotImplementedError):
            ttf.arch_spec(dataclasses.replace(kimi, **change))
