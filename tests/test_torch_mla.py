"""DeepSeek-V2's multi-head latent attention (MLA) in the port, against the
JAX package on the CPU.

Inputs come from numpy seeds, and both sides get the same weights
(``params.from_numpy``).  What is held, and how closely:

* ``AttnCfg``, the ``deepseek-v2-236b`` entry, its reduced variant and the
  one-card cut: the JAX package's fields, slot by slot; the full arch's
  leaves, of the same shapes (spec only: nothing is allocated); the cut's
  count, 2,054,947,840 parameters in 31 leaves (22 matrices); both
  packages refuse to page an MLA slot;
* ``mla_attention`` on one layer, plain and at ±ε, with a low-rank query
  (q_lora 32) and a single ``wq`` (q_lora 0): rtol 1e-5, atol 1e-5 —
  float32 products summed in different orders.  In both packages the
  output is bitwise the same when ``wukv``'s coordinates change (the
  reference reads that leaf unperturbed; the port copies it, ROADMAP
  Queue 3) and moves when ``wdkv``'s do;
* a prefill and four absorbed decode steps of the reduced DeepSeek-V2
  through the port's serving steps, against JAX's ``forward`` with its
  compressed cache: logits, ``ckv`` and ``krope`` within atol 1e-5,
  ``kpos`` equal; against the port's own no-cache forward at the same
  positions within 3e-4 (the absorbed product sums in another order);
* a 3-step SeedFlood run on 4 clients of one MLA + MoE layer (d32)
  against the JAX Trainer: ledger equal, loss curve rtol 1e-4, each step's
  coefficients within 1e-4 of its largest; and, fed the JAX run's
  coefficients (tests/test_torch_churn_width.py's method), each leaf
  within 1e-4 of its update, ``wukv`` (moved by the update though its
  perturbation never reaches the loss) included.  Left to its own
  coefficients the port ends further off than that, because the ZO
  coefficient (L+ − L−) / 2ε turns the two packages' float32 loss rounding
  into a coefficient gap (ROADMAP Queue 3): the coefficients differ by
  1.2e-6 (half an ulp of the loss over 2ε, times lr), which is 2.4e-4 of
  the update on this layer, 6.5e-4 at d32 with both layers and 2.7e-2 at
  d64, where updates cancel; fed, the gap is 2.3e-7 of the update
  (``_proof/mla23.py`` prints each).  One layer keeps the JAX run's
  compile (~36 s) inside the file's budget.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.data.synthetic import TaskConfig as JTask  # noqa: E402
from repro.dtrain.runner import DTrainConfig as JConfig  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.perturb import Bundle as JBundle  # noqa: E402
from repro.models.perturb import epoch_subspace as jepoch_subspace  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.data.synthetic import TaskConfig  # noqa: E402
from repro_torch.dtrain.runner import DTrainConfig, run  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import params as tplib, transformer as ttf  # noqa: E402
from repro_torch.models.perturb import Bundle, epoch_subspace, sample_pert  # noqa: E402

from _torch_parity import (jax_method_run, jax_slot_bundle,  # noqa: E402
                           record_coefficients, subcge_pair, weights)
from _torch_parity import one_thread  # noqa: E402,F401

# one torch thread per test: under pytest-xdist the intra-op pools of the
# workers wait on each other (tests/_torch_parity.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

DS = "deepseek-v2-236b"
RTOL = ATOL = 1e-5
#: the absorbed decode against the expanded no-cache forward (the JAX
#: package holds its own prefill and decode to its forward at 2e-4, 3e-4)
FORWARD_TOL = 3e-4
EPS = 1e-3
SEEDS = np.array([12345, 4294967295], np.uint32)
#: the one-card cut's size (JAX ``count_params`` on the same cut)
CUT_PARAMS = 2_054_947_840


def _slots(cfg):
    return [s for g in cfg.groups for s in g.slots]


def _jax_cut():
    """``archs.deepseek_cut`` built from the JAX package's entry."""
    dense, moe = jarchs.get(DS).groups
    s = moe.slots[0]
    s = dataclasses.replace(s, moe=dataclasses.replace(
        s.moe, n_experts=tarchs.DEEPSEEK_EXPERTS))
    return dataclasses.replace(jarchs.get(DS), groups=(
        dense, jbase.Group((s,), tarchs.DEEPSEEK_MOE_LAYERS)))


def _archs(q_lora=None):
    """The reduced DeepSeek-V2 of both packages; with ``q_lora`` given,
    every MLA slot's query rank replaced by it (0: one ``wq``)."""
    pair = []
    for mod in (jarchs, tarchs):
        a = mod.reduced(mod.get(DS))
        if q_lora is not None:
            a = dataclasses.replace(a, groups=tuple(
                dataclasses.replace(g, slots=tuple(
                    dataclasses.replace(s, attn=dataclasses.replace(
                        s.attn, q_lora=q_lora)) for s in g.slots))
                for g in a.groups))
        pair.append(a)
    return tuple(pair)


def test_configs_match_jax():
    assert [f.name for f in dataclasses.fields(tbase.AttnCfg)] \
        == [f.name for f in dataclasses.fields(jbase.AttnCfg)]
    pairs = [(jarchs.get(DS), tarchs.get(DS)), _archs(),
             (_jax_cut(), tarchs.deepseek_cut())]
    for arch_j, arch_t in pairs:
        for f in dataclasses.fields(arch_t):
            if f.name not in ("groups", "name"):
                assert getattr(arch_t, f.name) == getattr(arch_j, f.name)
        assert [g.reps for g in arch_t.groups] \
            == [g.reps for g in arch_j.groups]
        for sj, st in zip(_slots(arch_j), _slots(arch_t), strict=True):
            assert (st.mixer, st.ffn, st.d_ff) == (sj.mixer, sj.ffn, sj.d_ff)
            assert dataclasses.asdict(st.attn) == dataclasses.asdict(sj.attn)
            assert st.attn.is_mla and sj.attn.is_mla
            if st.moe is not None:
                assert dataclasses.asdict(st.moe) == dataclasses.asdict(sj.moe)
    full = tarchs.get(DS)
    assert full.n_layers == 60 and not full.tie_embeddings
    assert tarchs.reduced(full).name == jarchs.reduced(jarchs.get(DS)).name
    # the full arch: the JAX package's leaves, paths, shapes and init
    want = tplib.flatten(jtf.arch_spec(jarchs.get(DS)))
    got = ttf.arch_spec(full)
    assert set(got) == set(want)
    for p, w in want.items():
        g = got[p]
        assert (g.shape, g.n_batch_dims, g.init, g.scale) == \
            (w.shape, w.n_batch_dims, w.init, w.scale), p
    assert got["g1/s0/wukv"].shape == (59, 512, 128 * 256)
    assert got["g0/s0/wuq"].shape == (1, 1536, 128 * 192)
    # the one-card cut: the dense layer, 1 of 59 MoE layers, 20 experts
    cut = ttf.arch_spec(tarchs.deepseek_cut())
    assert tplib.n_params(cut) == jtf.count_params(_jax_cut()) == CUT_PARAMS
    meta = tplib.subcge_meta(cut)
    assert len(meta) == 31 and sum(m.is_matrix for m in meta.values()) == 22
    assert cut["g1/s0/w1"].shape == (1, 20, 5120, 1536)
    assert cut["g1/s0/router"].shape == (1, 5120, 20)
    assert cut["embed/out"].shape == (5120, 102_400)
    # neither package pages an MLA slot
    arch_j, arch_t = _archs()
    msg = "paged serving does not support MLA slots"
    for refuse in (lambda: jtf.check_paged_support(arch_j),
                   lambda: jsteps.build_paged_prefill_step(arch_j, None, None,
                                                           None),
                   lambda: jsteps.build_paged_decode_step(arch_j, None, None,
                                                          None),
                   lambda: ttf.check_paged_support(arch_t),
                   lambda: ttf.init_paged_pool(arch_t, 4, 4),
                   lambda: tsteps.build_paged_prefill_step(arch_t, 2, 8, 4),
                   lambda: tsteps.build_paged_decode_step(arch_t)):
        with pytest.raises(ValueError, match=msg):
            refuse()


def _moved(ij: tuple) -> tuple:
    """Other coordinates in the same range: each index shifted by one."""
    return tuple(torch.where(t > 0, t - 1, t + 1) for t in ij)


@pytest.fixture(scope="module")
def jax_layer():
    """The JAX package's ``mla_attention`` on one client's layer Bundle,
    jitted once per (config, perturbed or not) and reused by every case
    and sign (the scale is traced): (jb, x) -> (y, cache)."""
    fns = {}

    def layer(acfg, theta, jb, x):
        key = (acfg, theta, jb.scale is None)
        if key not in fns:
            def f(p, uv, ij, zv, scale, x):
                return jlayers.mla_attention(
                    JBundle(p, uv, ij, zv, scale, "jnp"), x, acfg, 0, None,
                    theta)
            fns[key] = jax.jit(f)
        return fns[key](jb.p, jb.uv, jb.ij, jb.zv, jb.scale, x)
    return layer


@pytest.mark.parametrize("q_lora", [32, 0], ids=["q_lora", "wq"])
@pytest.mark.parametrize("scale", [None, EPS, -EPS])
def test_mla_attention_matches_jax(scale, q_lora, jax_layer):
    arch_j, arch_t = _archs(q_lora)
    acfg_j = arch_j.groups[0].slots[0].attn
    acfg_t = arch_t.groups[0].slots[0].attn
    assert acfg_t.q_lora == q_lora
    meta_j, meta_t, cfg_j, cfg_t = subcge_pair(arch_j, arch_t, EPS)
    C = len(SEEDS)
    trees, stacked = weights(arch_j, C)
    assert ("g0/s0/wq" in stacked) == (q_lora == 0)
    x = np.random.default_rng(3).standard_normal(
        (C, 2, 9, arch_j.d_model)).astype(np.float32)
    xt = torch.from_numpy(x)
    sub_t = None if scale is None else epoch_subspace(meta_t, cfg_t, 5, 4)
    pert = None if scale is None else sample_pert(
        meta_t, cfg_t, torch.as_tensor(SEEDS.astype(np.int64)), scale)

    def port(pt):
        return tlayers.mla_attention(Bundle(stacked, sub_t, pt, "g0/s0/", 0),
                                     xt, acfg_t, arch_t.rope_theta)

    y = port(pert)
    sub_j = jepoch_subspace(meta_j, cfg_j, 5, 4)
    for c in range(C):
        jb = jax_slot_bundle(trees[c], meta_j, cfg_j, sub_j,
                             None if scale is None else SEEDS[c], scale)
        yj, nc = jax_layer(acfg_j, arch_j.rope_theta, jb, jnp.asarray(x[c]))
        assert nc is None
        np.testing.assert_allclose(y[c].numpy(), np.asarray(yj), rtol=RTOL,
                                   atol=ATOL)
        if scale is None:
            continue
        # the reference reads wukv raw: other coordinates for it leave the
        # output bitwise as it was, other coordinates for wdkv do not
        for leaf, same in (("wukv", True), ("wdkv", False)):
            ij = jb.ij[leaf]
            moved = type(ij)(*(jnp.where(a > 0, a - 1, a + 1) for a in ij))
            yk, _ = jax_layer(acfg_j, arch_j.rope_theta,
                              JBundle(jb.p, jb.uv, {**jb.ij, leaf: moved},
                                      jb.zv, jb.scale, jb.kb),
                              jnp.asarray(x[c]))
            assert np.array_equal(np.asarray(yk), np.asarray(yj)) == same, leaf
    if scale is not None:
        for leaf, same in (("wukv", True), ("wdkv", False)):
            path = "g0/s0/" + leaf
            yk = port(pert._replace(ij={**pert.ij,
                                        path: _moved(pert.ij[path])}))
            assert torch.equal(yk, y) == same, leaf


def test_prefill_and_absorbed_decode_match_jax():
    arch_j, arch_t = _archs()
    (jp,), tp = weights(arch_j, 1, seed=1)
    B, PL, NEW, CAP = 3, 12, 4, 20
    fwd = jax.jit(jtf.forward, static_argnums=0)
    prompts = np.random.default_rng(4).integers(
        0, arch_t.vocab, (B, PL)).astype(np.int32)
    jc = jtf.init_cache(arch_j, B, CAP, jnp.float32)
    jl, jc, _ = fwd(arch_j, jp, {"tokens": jnp.asarray(prompts)}, cache=jc,
                    pos=0)
    last, tc = tsteps.build_prefill_step(arch_t, B, CAP)(
        tp, torch.as_tensor(prompts).long())
    assert set(tc) == {"g0/s0", "g0/s1"}
    assert tc["g0/s0"]["ckv"].shape == (1, B, CAP, 16)
    assert tc["g0/s1"]["krope"].shape == (1, B, CAP, 8)
    np.testing.assert_allclose(last.numpy(), np.asarray(jl[:, -1]), rtol=0,
                               atol=ATOL, err_msg="prefill")
    rows, fed = [last], []
    decode = tsteps.build_decode_step(arch_t)
    for i in range(NEW):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        fed.append(tok)
        jl, jc, _ = fwd(arch_j, jp, {"tokens": jnp.asarray(tok)}, cache=jc,
                        pos=jnp.int32(PL + i))
        lg, tc = decode(tp, tc, torch.as_tensor(tok).long(), PL + i)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl[:, 0]), rtol=0,
                                   atol=ATOL, err_msg=f"decode {i}")
        rows.append(lg)
    for sk in ("s0", "s1"):
        for name in ("ckv", "krope"):
            np.testing.assert_allclose(
                tc["g0/" + sk][name].numpy(), np.asarray(jc["g0"][sk][name]),
                rtol=0, atol=ATOL, err_msg=f"{sk} {name}")
        np.testing.assert_array_equal(tc["g0/" + sk]["kpos"].numpy(),
                                      np.asarray(jc["g0"][sk]["kpos"]))
    assert (tc["g0/s0"]["kpos"][0].numpy()
            == np.r_[np.arange(PL + NEW), [-1] * (CAP - PL - NEW)]).all()
    # the port's no-cache forward over prompt + fed tokens: its logits at
    # positions PL - 1 .. PL + NEW - 1 are the prefill's and the decodes'
    full = torch.as_tensor(np.concatenate([prompts] + fed, axis=1)).long()
    ref = ttf.forward(arch_t, tp, full[None])[0][0]
    for i, row in enumerate(rows):
        np.testing.assert_allclose(row.numpy(), ref[:, PL - 1 + i].numpy(),
                                   rtol=FORWARD_TOL, atol=FORWARD_TOL,
                                   err_msg=f"step {i} vs no-cache forward")


def _moe_layer(mod):
    """One MLA + MoE layer of the reduced DeepSeek-V2 at d32 (the kind 59
    of its 60 layers are), from ``mod`` (either package's ``archs``)."""
    a = mod.reduced(mod.get(DS), d_model=32)
    (g,) = a.groups
    return dataclasses.replace(a, groups=(dataclasses.replace(
        g, slots=g.slots[1:]),))


def test_seedflood_run_matches_jax(monkeypatch):
    arch_j, arch_t = _moe_layer(jarchs), _moe_layer(tarchs)
    assert [(s.attn.is_mla, s.ffn) for s in _slots(arch_t)] == [(True, "moe")]
    kw = dict(n_clients=4, steps=3, batch_size=2)
    task = dict(vocab=256, n_valid=8, n_test=64)
    jax_coefs, own_coefs, fed_coefs = {}, {}, {}
    rj = jax_method_run(JConfig(arch=arch_j, task=JTask(**task), **kw),
                        coefs=jax_coefs)
    runs = {}
    for key, coefs, fed in (("own", own_coefs, None),
                            ("fed", fed_coefs, jax_coefs)):
        record_coefficients(monkeypatch, coefs, fed)
        runs[key] = run(DTrainConfig(arch=arch_t, task=TaskConfig(**task),
                                     device="cpu", **kw))
    want = tplib.flatten(jax.tree.map(np.asarray, rj.extra["final_stacked"]))
    init = tplib.flatten(jax.tree.map(np.asarray, jtf.init_params(arch_j, 0)))
    for rt in runs.values():
        assert (rt.extra["n_messages"], rt.total_bytes) == \
            (rj.extra["n_messages"], rj.total_bytes)
        np.testing.assert_allclose(rt.loss_curve, rj.loss_curve, rtol=1e-4)
        assert rt.consensus_error < 1e-10
        assert set(rt.extra["final_stacked"]) == set(want)
    # each step's coefficients within 1e-4 of the step's largest
    for t, c in jax_coefs.items():
        np.testing.assert_allclose(own_coefs[t], c, rtol=0,
                                   atol=1e-4 * float(np.abs(c).max()))
        assert np.array_equal(fed_coefs[t], c), t
    # fed the JAX coefficients, every leaf ends within 1e-4 of its update,
    # wukv among them: SubCGE moves it in both packages, though its
    # perturbation never reaches the loss
    got = runs["fed"].extra["final_stacked"]
    for p, w in want.items():
        update = float(np.abs(w - init[p][None]).max())
        assert update > 0, p
        np.testing.assert_allclose(got[p].numpy(), w, rtol=0,
                                   atol=1e-4 * update, err_msg=p)
    assert "g0/s0/wukv" in want
