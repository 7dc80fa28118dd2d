"""Jamba's hybrid layers and the Mamba decode cache in the port, against the
JAX package on the CPU.

Inputs come from numpy seeds, and both sides get the same weights
(``params.from_numpy``).  What is held, and how closely:

* the ``jamba-1.5-large-398b`` entry, its reduced variant (an attention +
  dense slot and a Mamba + MoE slot at d64) and the one-card cut
  (``archs.jamba_cut``): the JAX package's fields, slot by slot; every
  leaf's path, shape and init (specs only: nothing is allocated); the
  cut's count, 3,457,064,960 parameters in 27 leaves (19 matrices), the
  JAX ``count_params`` on the same cut; both packages refuse to page a
  Mamba slot;
* ``lm_loss`` of the reduced Jamba, plain and at ±ε: rtol 1e-5 (float32
  products summed in other orders); its MoE aux is not 0, so the FFN after
  the Mamba slot ran;
* ``layers.mamba`` with a cache against the JAX ``mamba`` with its cache
  (built at float32: its ``init_cache`` defaults to bfloat16): a prefill
  of T tokens, then 3 decode steps; ``y``, ``h`` and ``conv`` within rtol /
  atol 1e-5.  The reference's two edge cases, pinned: a second prefill
  onto a live cache zero-pads its conv while its scan starts from the
  cached state (the JAX layer's output moves off a one-prefill run by
  more than 1e-3), and a prompt shorter than d_conv − 1 leaves a conv
  cache too short for its decode step (the JAX layer raises).  The port's
  conv reads the cached tail instead (bitwise the zero pad on a fresh
  cache): its two prefills equal one prefill, and its short prompt then
  decodes like the no-cache layer, both within 1e-5;
* prefill and decode through ``launch.steps`` for the reduced Jamba and the
  reduced Falcon Mamba: logits within atol 1e-5 of JAX's ``forward`` with
  its cache, every cache leaf within 1e-5 of JAX's, and within rtol / atol
  3e-4 of the port's own no-cache forward at the same positions;
* a 3-step SeedFlood run on 4 clients of the reduced Jamba's Mamba + MoE
  layer against the JAX Trainer: ledger equal, loss curve rtol 1e-4, each
  step's coefficients within 1e-4 of its largest; and, fed the JAX run's
  coefficients (``_torch_parity.record_coefficients``), each leaf within
  1e-4 of its update (the MLA test's method: the ZO coefficient (L+ − L−)
  / 2ε turns the two packages' float32 loss rounding into a coefficient
  gap, ROADMAP Queue 3).  The one layer, the slot kind no other slice
  has, keeps the JAX run's compile (~38 s; ~52 s with the attention +
  dense slot too) inside the file's budget.
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
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.perturb import Bundle as JBundle  # noqa: E402
from repro.models.perturb import epoch_subspace as jepoch_subspace  # noqa: E402
from repro.models.perturb import sample_pert as jsample_pert  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.data.synthetic import TaskConfig  # noqa: E402
from repro_torch.dtrain.runner import DTrainConfig, run  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import params as tplib, transformer as ttf  # noqa: E402
from repro_torch.models.perturb import Bundle, epoch_subspace, sample_pert  # noqa: E402

from _torch_parity import (jax_method_run, record_coefficients,  # noqa: E402
                           subcge_pair, weights)
from _torch_parity import one_thread  # noqa: E402,F401

# one torch thread per test: under pytest-xdist the intra-op pools of the
# workers wait on each other (tests/_torch_parity.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

JAMBA, FALCON = "jamba-1.5-large-398b", "falcon-mamba-7b"
RTOL = ATOL = 1e-5
#: cached logits against the no-cache forward (the JAX package holds its
#: own prefill and decode to its forward at 2e-4, 3e-4)
FORWARD_TOL = 3e-4
EPS = 1e-3
SEEDS = np.array([12345, 4294967295], np.uint32)
#: the one-card cut's size (JAX ``count_params`` on the same cut)
CUT_PARAMS = 3_457_064_960


def _slots(cfg):
    return [s for g in cfg.groups for s in g.slots]


def _jax_cut():
    """``archs.jamba_cut`` built from the JAX package's entry."""
    attn, mam = jarchs.get(JAMBA).groups[0].slots[:2]
    mam = dataclasses.replace(mam, moe=dataclasses.replace(
        mam.moe, n_experts=tarchs.JAMBA_EXPERTS))
    return dataclasses.replace(jarchs.get(JAMBA),
                               groups=(jbase.Group((attn, mam), 1),))


def _reduced(name):
    return jarchs.reduced(jarchs.get(name)), tarchs.reduced(tarchs.get(name))


def test_configs_and_specs_match_jax():
    pairs = [(jarchs.get(JAMBA), tarchs.get(JAMBA)), _reduced(JAMBA),
             (_jax_cut(), tarchs.jamba_cut())]
    for arch_j, arch_t in pairs:
        for f in dataclasses.fields(arch_t):
            if f.name not in ("groups", "name"):
                assert getattr(arch_t, f.name) == getattr(arch_j, f.name)
        assert [g.reps for g in arch_t.groups] \
            == [g.reps for g in arch_j.groups]
        for sj, st in zip(_slots(arch_j), _slots(arch_t), strict=True):
            assert (st.mixer, st.ffn, st.d_ff) == (sj.mixer, sj.ffn, sj.d_ff)
            for part in ("attn", "moe"):
                pt, pj = getattr(st, part), getattr(sj, part)
                assert (pt is None) == (pj is None), part
                if pt is not None:
                    assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
            if st.mamba is not None:
                mj = dataclasses.asdict(sj.mamba)
                assert mj.pop("chunk") and dataclasses.asdict(st.mamba) == mj
        want = tplib.flatten(jtf.arch_spec(arch_j))
        got = ttf.arch_spec(arch_t)
        assert set(got) == set(want)
        for p, w in want.items():
            g = got[p]
            assert (g.shape, g.n_batch_dims, g.init, g.scale) == \
                (w.shape, w.n_batch_dims, w.init, w.scale), p
    full = tarchs.get(JAMBA)
    assert full.n_layers == 72 and full.family == "hybrid"
    assert [(s.mixer, s.ffn) for s in _slots(full)] == \
        [("attn", "dense")] + [("mamba", "moe"), ("mamba", "dense")] * 3 \
        + [("mamba", "moe")]
    red = tarchs.reduced(full)
    assert red.name == jarchs.reduced(jarchs.get(JAMBA)).name
    assert red.d_model == 64 and [(s.mixer, s.ffn) for s in _slots(red)] \
        == [("attn", "dense"), ("mamba", "moe")]
    # the cut: every width, 2 of 16 experts, the JAX count
    cut = ttf.arch_spec(tarchs.jamba_cut())
    assert tplib.n_params(cut) == jtf.count_params(_jax_cut()) == CUT_PARAMS
    meta = tplib.subcge_meta(cut)
    assert len(meta) == 27 and sum(m.is_matrix for m in meta.values()) == 19
    assert cut["g0/s1/in_proj"].shape == (1, 8192, 32_768)
    assert cut["g0/s1/x_proj"].shape == (1, 16_384, 512 + 32)
    assert cut["g0/s1/w1"].shape == (1, 2, 8192, 24_576)
    assert cut["g0/s1/router"].shape == (1, 8192, 2)
    assert cut["g0/s0/w2"].shape == (1, 24_576, 8192)
    assert cut["embed/out"].shape == (8192, 65_536)
    # neither package pages a Mamba slot's recurrent state
    arch_j, arch_t = _reduced(JAMBA)
    msg = "paged serving does not support mamba slots"
    for refuse in (lambda: jtf.check_paged_support(arch_j),
                   lambda: ttf.init_paged_pool(arch_t, 4, 4),
                   lambda: tsteps.build_paged_prefill_step(arch_t, 2, 8, 4),
                   lambda: tsteps.build_paged_decode_step(arch_t)):
        with pytest.raises(ValueError, match=msg):
            refuse()


def test_lm_loss_matches_jax():
    arch_j, arch_t = _reduced(JAMBA)
    C = len(SEEDS)
    trees, stacked = weights(arch_j, C)
    toks = np.random.default_rng(1).integers(0, arch_j.vocab, (C, 2, 17),
                                             dtype=np.int32)
    meta_j, meta_t, cfg_j, cfg_t = subcge_pair(arch_j, arch_t, EPS)
    sub_t = epoch_subspace(meta_t, cfg_t, 5, 4)
    pert_t = sample_pert(meta_t, cfg_t, torch.as_tensor(SEEDS.astype(np.int64)),
                         EPS)
    tt = torch.as_tensor(toks)
    got = {None: ttf.lm_loss(arch_t, stacked, tt),
           EPS: ttf.lm_loss(arch_t, stacked, tt, sub=sub_t, pert=pert_t),
           -EPS: ttf.lm_loss(arch_t, stacked, tt, sub=sub_t,
                             pert=pert_t.with_scale(-EPS))}
    # the MoE after the Mamba slot ran: its aux loss is in the sum
    assert (ttf.forward(arch_t, stacked, tt)[1] > 0).all()

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
                                       rtol=RTOL)
    assert float(got[EPS][0]) != float(got[-EPS][0])


def test_mamba_cache_matches_jax():
    arch_j, arch_t = _reduced(JAMBA)
    mj, mt = _slots(arch_j)[1].mamba, _slots(arch_t)[1].mamba
    (tree,), stacked = weights(arch_j, 1, seed=2)
    jp = jax.tree.map(lambda a: a[0], tree["g0"]["s1"])
    tb = Bundle(stacked, None, None, "g0/s1/", 0)
    B, P, NEW, D = 3, 9, 3, arch_j.d_model
    x = np.random.default_rng(5).standard_normal(
        (B, P + NEW, D)).astype(np.float32)

    def fresh(Bc=B):
        jc = jtf.init_cache(arch_j, Bc, 1, jnp.float32)["g0"]["s1"]
        tc = ttf.init_cache(arch_t, Bc, 1)["g0/s1"]
        return jax.tree.map(lambda a: a[0], jc), {k: t[0] for k, t in
                                                  tc.items()}

    def port(xs, cache=None):
        return tlayers.mamba(tb, torch.from_numpy(xs)[None], mt, cache)[0]

    layer = jax.jit(lambda p, xs, cache: jlayers.mamba(JBundle(p, kb="jnp"),
                                                      xs, mj, cache))

    def jax_layer(xs, cache=None):
        return layer(jp, jnp.asarray(xs), cache)

    jc, tc = fresh()
    assert tc["h"].shape == (B, 128, 4) and tc["conv"].shape == (B, 3, 128)
    spans = [(0, P)] + [(P + i, P + i + 1) for i in range(NEW)]
    for lo, hi in spans:
        yj, jc = jax_layer(x[:, lo:hi], jc)
        yt = port(x[:, lo:hi], tc)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=RTOL,
                                   atol=ATOL, err_msg=f"y {lo}:{hi}")
        for k in ("h", "conv"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k} {lo}:{hi}")
    # a second prefill onto a live cache: the port's equals one prefill of
    # both spans; the reference's conv restarts from zeros under the old h
    whole = port(x)
    jc, tc = fresh()
    _, jc = jax_layer(x[:, :5], jc)
    y2, _ = jax_layer(x[:, 5:], jc)
    yt = torch.cat([port(x[:, :5], tc), port(x[:, 5:], tc)], dim=1)
    np.testing.assert_allclose(yt.numpy(), whole.numpy(), rtol=RTOL,
                               atol=ATOL)
    jwhole, _ = jax_layer(x, None)
    assert float(jnp.abs(y2 - jwhole[:, 5:]).max()) > 1e-3
    # a prompt shorter than d_conv - 1: the port's decode step reads a
    # whole window (the zero-padded history); the reference's cache is
    # too short for its step
    jc, tc = fresh()
    _, jc = jax_layer(x[:, :2], jc)
    assert jc["conv"].shape == (B, 2, 128)
    with pytest.raises(ValueError):
        jax_layer(x[:, 2:3], jc)
    yt = torch.cat([port(x[:, :2], tc), port(x[:, 2:3], tc)], dim=1)
    np.testing.assert_allclose(yt.numpy(), port(x[:, :3]).numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", [JAMBA, FALCON])
def test_prefill_and_decode_match_jax(name):
    arch_j, arch_t = _reduced(name)
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
    mamba_keys = [f"g0/s{i}" for i, s in enumerate(_slots(arch_t))
                  if s.mixer == "mamba"]
    assert mamba_keys and set(tc[mamba_keys[0]]) == {"h", "conv"}
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
    for key, c in tc.items():
        gi, si = key.split("/")
        for leaf, t in c.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jc[gi][si][leaf]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{key} {leaf}")
    full = torch.as_tensor(np.concatenate([prompts] + fed, axis=1)).long()
    ref = ttf.forward(arch_t, tp, full[None])[0][0]
    for i, row in enumerate(rows):
        np.testing.assert_allclose(row.numpy(), ref[:, PL - 1 + i].numpy(),
                                   rtol=FORWARD_TOL, atol=FORWARD_TOL,
                                   err_msg=f"step {i} vs no-cache forward")


def _mamba_moe_layer(mod):
    """The reduced Jamba's Mamba + MoE slot alone, from ``mod`` (either
    package's ``archs``)."""
    a = mod.reduced(mod.get(JAMBA))
    (g,) = a.groups
    return dataclasses.replace(a, groups=(dataclasses.replace(
        g, slots=g.slots[1:]),))


def test_seedflood_run_matches_jax(monkeypatch):
    arch_j, arch_t = _mamba_moe_layer(jarchs), _mamba_moe_layer(tarchs)
    assert [(s.mixer, s.ffn) for s in _slots(arch_t)] == [("mamba", "moe")]
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
    for t, c in jax_coefs.items():
        np.testing.assert_allclose(own_coefs[t], c, rtol=0,
                                   atol=1e-4 * float(np.abs(c).max()))
        assert np.array_equal(fed_coefs[t], c), t
    got = runs["fed"].extra["final_stacked"]
    for p, w in want.items():
        update = float(np.abs(w - init[p][None]).max())
        assert update > 0, p
        np.testing.assert_allclose(got[p].numpy(), w, rtol=0,
                                   atol=1e-4 * update, err_msg=p)
    assert {"g0/s0/ln_mlp_scale", "g0/s0/w1", "g0/s0/in_proj"} <= set(want)
