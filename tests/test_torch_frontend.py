"""The frontend archs (MusicGen-medium, InternVL2-26B), sinusoidal positions,
frozen leaves and the pod runtime's train steps in the port, against the
JAX package on the CPU.

Inputs come from numpy seeds, and both sides get the same weights
(``params.from_numpy``, or each side's own ``init_params``, bitwise the
same).  What is held, and how closely:

* ``FrontendCfg``, both archs, their reduced variants and the InternVL cut:
  the JAX package's fields; the leaves' paths, shapes and init; the
  parameter counts (1,366,723,584 in 15 leaves; 19,880,921,088 and, cut to
  1 of 48 layers, 1,547,040,768 in 13); both packages refuse to page a
  frontend arch.  ``sinusoidal_pos`` against the JAX table at positions up
  to 4095 and past it (unclipped): within one float32 ulp of the position
  (the angle pos·f carries that rounding, and the two packages' ``exp``
  round some frequencies f an ulp apart, which the position multiplies);
* ``forward`` and ``lm_loss`` of the reduced MusicGen (sinusoidal
  positions, layernorm, plain gelu MLP) and InternVL (rope, GQA, gated
  silu) with 8 embeddings of width 32, plain and at ±ε: logits and losses
  rtol 1e-5, atol 1e-5 — float32 products summed in different orders;
* a prefill with the embeddings and three decode steps of both, through
  the port's serving steps, against JAX's ``forward`` with its cache
  (atol 1e-5) and the port's own no-cache forward (3e-4, the JAX
  package's tolerance for its own, ``tests/test_models.py``);
* frozen leaves (one matrix, one vector) through ``apply_messages``,
  ``apply_messages_epoch``, ``sample_pert`` and ``mezo_z``: bitwise
  untouched (no coordinates, no Gaussian, zeros), the other leaves
  matching JAX (updates atol 1e-6, draws bitwise);
* ``build_seedflood_train_step`` and ``build_dsgd_train_step`` of the
  reduced InternVL with embeddings, 2 clients, 2 steps each, against the
  JAX steps jitted on a 1 × 1 host mesh (the JAX step's coefficients
  recorded from inside its jit): the metrics rtol 1e-5; each step's
  coefficients within 1e-4 of its largest; fed the JAX run's
  coefficients (tests/test_torch_mla.py's method), every leaf of the
  SeedFlood run within atol 1e-6, and every leaf of the DSGD run within
  the same.  Left to its own coefficients the port ends 1.7e-4 from JAX:
  the coefficients differ by 7-8e-6 of the largest, the ZO coefficient
  (L+ − L−) / 2ε turning the two packages' float32 loss rounding into a
  gap (ROADMAP Queue 3); fed, 1.2e-7.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs.base import InputShape  # noqa: E402
from repro.core import subcge as jsub, zo as jzo  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.perturb import epoch_subspace as jepoch_subspace  # noqa: E402
from repro.models.perturb import sample_pert as jsample_pert  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import subcge as tsub, zo as tzo  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import params as tplib, transformer as ttf  # noqa: E402
from repro_torch.models.perturb import epoch_subspace, sample_pert  # noqa: E402

from _torch_parity import subcge_pair, weights  # noqa: E402
from _torch_parity import one_thread  # noqa: E402,F401

# one torch thread per test: under pytest-xdist the intra-op pools of the
# workers wait on each other (tests/_torch_parity.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

MG, VL = "musicgen-medium", "internvl2-26b"
RTOL = ATOL = 1e-5
FORWARD_TOL = 3e-4
EPS = 1e-3
SEEDS = np.array([12345, 4294967295], np.uint32)
COUNTS = {MG: (1_366_723_584, 15), VL: (19_880_921_088, 13),
          "cut": (1_547_040_768, 13)}


def _pair(name):
    return jarchs.reduced(jarchs.get(name)), tarchs.reduced(tarchs.get(name))


def _inputs(arch, C, B, T, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, arch.vocab, (C, B, T), dtype=np.int32)
    fe = arch.frontend
    emb = rng.standard_normal((C, B, fe.n_embeds, fe.embed_dim)).astype(
        np.float32)
    return toks, emb


def test_configs_counts_and_positions_match_jax():
    assert [f.name for f in dataclasses.fields(tbase.FrontendCfg)] \
        == [f.name for f in dataclasses.fields(jbase.FrontendCfg)]
    cut_j = dataclasses.replace(jarchs.get(VL), groups=(jbase.Group(
        jarchs.get(VL).groups[0].slots, tarchs.INTERNVL_LAYERS),))
    pairs = {MG: (jarchs.get(MG), tarchs.get(MG)),
             VL: (jarchs.get(VL), tarchs.get(VL)),
             "cut": (cut_j, tarchs.internvl_cut()),
             "mg-reduced": _pair(MG), "vl-reduced": _pair(VL)}
    for key, (arch_j, arch_t) in pairs.items():
        for f in dataclasses.fields(arch_t):
            if f.name not in ("groups", "name", "frontend"):
                assert getattr(arch_t, f.name) == getattr(arch_j, f.name), \
                    (key, f.name)
        assert dataclasses.asdict(arch_t.frontend) \
            == dataclasses.asdict(arch_j.frontend)
        assert [(g.reps, len(g.slots)) for g in arch_t.groups] \
            == [(g.reps, len(g.slots)) for g in arch_j.groups]
        for g_j, g_t in zip(arch_j.groups, arch_t.groups):
            for sj, st in zip(g_j.slots, g_t.slots, strict=True):
                assert (st.mixer, st.ffn, st.d_ff) == (sj.mixer, sj.ffn,
                                                       sj.d_ff)
                assert dataclasses.asdict(st.attn) \
                    == dataclasses.asdict(sj.attn)
        want = tplib.flatten(jtf.arch_spec(arch_j))
        got = ttf.arch_spec(arch_t)
        assert set(got) == set(want), key
        for p, w in want.items():
            g = got[p]
            assert (g.shape, g.n_batch_dims, g.init, g.scale, g.frozen) == \
                (w.shape, w.n_batch_dims, w.init, w.scale, w.frozen), p
        if key in COUNTS:
            assert (tplib.n_params(got), len(got)) == COUNTS[key]
            assert jtf.count_params(arch_j) == COUNTS[key][0]
    assert tarchs.get(VL).frontend.n_embeds == 1024
    assert ttf.arch_spec(tarchs.internvl_cut())["frontend/proj"].shape \
        == (3200, 6144)
    # neither package pages a frontend arch
    arch_j, arch_t = _pair(MG)
    for refuse in (lambda: jtf.check_paged_support(arch_j),
                   lambda: jsteps.build_paged_prefill_step(arch_j, None, None,
                                                           None),
                   lambda: ttf.check_paged_support(arch_t),
                   lambda: ttf.init_paged_pool(arch_t, 4, 4),
                   lambda: tsteps.build_paged_prefill_step(arch_t, 2, 8, 4),
                   lambda: tsteps.build_paged_decode_step(arch_t)):
        with pytest.raises(ValueError, match="text-decode only"):
            refuse()
    # the sinusoidal table, unclipped past the learned table's 4096
    pos = np.r_[np.arange(4096), [4096, 10_000, 131_071]].astype(np.int32)
    table = jax.jit(jlayers.sinusoidal_pos, static_argnums=1)
    for d in (64, 1536):
        want = np.asarray(table(jnp.asarray(pos), d))
        got = tlayers.sinusoidal_pos(torch.as_tensor(pos), d).numpy()
        assert got.dtype == np.float32 and got.shape == (len(pos), d)
        ulp = np.spacing(np.maximum(pos, 1).astype(np.float32))[:, None]
        assert (np.abs(got - want) <= ulp).all(), d
        np.testing.assert_array_equal(got[0], want[0])


def test_forward_and_loss_with_embeds_match_jax():
    for name in (MG, VL):
        _forward_and_loss_match(name)


def _forward_and_loss_match(name):
    arch_j, arch_t = _pair(name)
    C, B, T = len(SEEDS), 2, 9
    trees, stacked = weights(arch_j, C)
    toks, emb = _inputs(arch_j, C, B, T, 1)
    meta_j, meta_t, cfg_j, cfg_t = subcge_pair(arch_j, arch_t, EPS)
    sub_t = epoch_subspace(meta_t, cfg_t, 5, 4)
    pert_t = sample_pert(meta_t, cfg_t,
                         torch.as_tensor(SEEDS.astype(np.int64)), EPS)
    assert "frontend/proj" in pert_t.ij
    tt, te = torch.as_tensor(toks), torch.as_tensor(emb)
    logits_t, _ = ttf.forward(arch_t, stacked, tt, embeds=te)
    assert logits_t.shape == (C, B, arch_t.frontend.n_embeds + T,
                              arch_t.vocab)
    got = {None: ttf.lm_loss(arch_t, stacked, tt, embeds=te),
           EPS: ttf.lm_loss(arch_t, stacked, tt, embeds=te, sub=sub_t,
                            pert=pert_t),
           -EPS: ttf.lm_loss(arch_t, stacked, tt, embeds=te, sub=sub_t,
                             pert=pert_t.with_scale(-EPS))}

    sub_j = jepoch_subspace(meta_j, cfg_j, 5, 4)
    fwd = jax.jit(lambda p, b: jtf.forward(arch_j, p, b)[0])
    plain = jax.jit(lambda p, b: jtf.lm_loss(arch_j, p, b))

    @jax.jit
    def perturbed(p, b, seed, scale):
        pert = jsample_pert(meta_j, cfg_j, seed, scale)
        return jtf.lm_loss(arch_j, p, b, sub=sub_j, pert=pert,
                           kernel_backend="jnp")

    for c in range(C):
        b = {"tokens": jnp.asarray(toks[c]), "embeds": jnp.asarray(emb[c])}
        np.testing.assert_allclose(logits_t[c].numpy(),
                                   np.asarray(fwd(trees[c], b)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
        want = {None: plain(trees[c], b),
                EPS: perturbed(trees[c], b, SEEDS[c], EPS),
                -EPS: perturbed(trees[c], b, SEEDS[c], -EPS)}
        for sign, w in want.items():
            np.testing.assert_allclose(float(got[sign][c]), float(w),
                                       rtol=RTOL, err_msg=(name, sign))
    # the embeddings are read: without them the loss is another
    text_only = ttf.lm_loss(arch_t, stacked, tt)
    assert float(text_only[0]) != float(got[None][0])
    assert float(got[EPS][0]) != float(got[-EPS][0])


def test_prefill_with_embeds_and_decode_match_jax():
    fwd = jax.jit(jtf.forward, static_argnums=0)
    for name in (MG, VL):
        arch_j, arch_t = _pair(name)
        (jp,), tp = weights(arch_j, 1, seed=2)
        B, PL, NEW = 2, 6, 3
        P = arch_t.frontend.n_embeds
        CAP = P + PL + NEW
        toks, emb = _inputs(arch_j, 1, B, PL, 3)
        prompts, emb = toks[0], emb[0]
        jc = jtf.init_cache(arch_j, B, CAP, jnp.float32)
        jl, jc, _ = fwd(arch_j, jp, {"tokens": jnp.asarray(prompts),
                                     "embeds": jnp.asarray(emb)},
                        cache=jc, pos=0)
        prefill = tsteps.build_prefill_step(arch_t, B, CAP)
        with pytest.raises(ValueError, match="embeddings"):
            prefill(tp, torch.as_tensor(prompts).long())
        last, tc = prefill(tp, torch.as_tensor(prompts).long(),
                           torch.as_tensor(emb))
        np.testing.assert_allclose(last.numpy(), np.asarray(jl[:, -1]),
                                   rtol=0, atol=ATOL, err_msg="prefill")
        rows, fed = [last], []
        decode = tsteps.build_decode_step(arch_t)
        for i in range(NEW):
            tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(
                np.int32)
            fed.append(tok)
            jl, jc, _ = fwd(arch_j, jp, {"tokens": jnp.asarray(tok)},
                            cache=jc, pos=jnp.int32(P + PL + i))
            lg, tc = decode(tp, tc, torch.as_tensor(tok).long(), P + PL + i)
            np.testing.assert_allclose(lg.numpy(), np.asarray(jl[:, 0]),
                                       rtol=0, atol=ATOL,
                                       err_msg=f"{name} decode {i}")
            rows.append(lg)
        for name_k in ("k", "v"):
            np.testing.assert_allclose(
                tc["g0/s0"][name_k].numpy(),
                np.asarray(jc["g0"]["s0"][name_k]), rtol=0, atol=ATOL)
        assert (tc["g0/s0"]["kpos"][0].numpy() == np.arange(CAP)).all()
        # the port's no-cache forward over embeddings + prompt + fed tokens
        full = torch.as_tensor(np.concatenate([prompts] + fed, axis=1)).long()
        ref = ttf.forward(arch_t, tp, full[None],
                          embeds=torch.as_tensor(emb)[None])[0][0]
        for i, row in enumerate(rows):
            np.testing.assert_allclose(
                row.numpy(), ref[:, P + PL - 1 + i].numpy(),
                rtol=FORWARD_TOL, atol=FORWARD_TOL,
                err_msg=f"{name} step {i} vs no-cache forward")


def test_frozen_leaves_match_jax():
    rng = np.random.default_rng(5)
    shapes = {"emb": (16, 8), "ln": (8,), "blk/w": (2, 8, 6), "blk/b": (6,)}
    flat = {p: (0.1 * rng.standard_normal(s)).astype(np.float32)
            for p, s in shapes.items()}
    frozen = ("emb", "ln")
    tree_j = jax.tree.map(jnp.asarray, tplib.nest(flat))
    meta_j = jsub.infer_meta(tree_j, frozen_fn=lambda p: p in frozen)
    meta_t = tsub.infer_meta({p: torch.as_tensor(v) for p, v in flat.items()},
                             frozen_fn=lambda p: p in frozen)
    assert {p: dataclasses.astuple(m) for p, m in meta_t.items()} \
        == {p: dataclasses.astuple(m) for p, m in meta_j.items()}
    assert [p for p, m in meta_t.items() if m.is_matrix] == ["blk/w"]
    cfg_j = jsub.SubCGEConfig(rank=4, refresh_period=2, kernel_backend="jnp")
    cfg_t = tsub.SubCGEConfig(rank=4, refresh_period=2)
    K = 3
    seeds = rng.integers(0, 2**32, K, dtype=np.uint32)
    coefs = rng.standard_normal(K).astype(np.float32)
    steps = np.array([1, 2, 3], np.int32)          # two τ-epochs
    epochs = jsub.epoch_slots(steps, cfg_j)

    def stacked():
        return {p: torch.as_tensor(v)[None].clone() for p, v in flat.items()}

    sd, cf = (torch.as_tensor(seeds.astype(np.int64))[None],
              torch.as_tensor(coefs)[None])
    sub_t = tsub.subspace_at_step(meta_t, cfg_t, 9, 3)
    runs = {
        "apply_messages": (
            tsub.apply_messages(stacked(), meta_t, cfg_t, sub_t, sd, cf),
            jsub.apply_messages(tree_j, meta_j, cfg_j,
                                jsub.subspace_at_step(meta_j, cfg_j, 9, 3),
                                jnp.asarray(seeds), jnp.asarray(coefs))),
        "apply_messages_epoch": (
            tsub.apply_messages_epoch(stacked(), meta_t, cfg_t, 9, sd, cf,
                                      torch.as_tensor(steps)[None], epochs),
            jsub.apply_messages_epoch(tree_j, meta_j, cfg_j, 9,
                                      jnp.asarray(seeds), jnp.asarray(coefs),
                                      jnp.asarray(steps),
                                      jnp.asarray(epochs)))}
    vel = tsub.zero_buffers(meta_t, cfg_t)
    runs["momentum_apply"] = (tsub.momentum_apply(
        stacked(), meta_t, cfg_t, sub_t, vel, sd, cf)[0], None)
    for what, (got, want) in runs.items():
        for p in frozen:
            np.testing.assert_array_equal(got[p][0].numpy(), flat[p],
                                          err_msg=f"{what} {p}")
        for p in ("blk/w", "blk/b"):
            assert not np.array_equal(got[p][0].numpy(), flat[p]), (what, p)
            if want is not None:
                np.testing.assert_allclose(
                    got[p][0].numpy(), np.asarray(tplib.flatten(want)[p]),
                    rtol=0, atol=1e-6, err_msg=f"{what} {p}")
    # RNG_S: no coordinates and no Gaussian for a frozen leaf
    pert_t = sample_pert(meta_t, cfg_t, torch.as_tensor(
        seeds[:1].astype(np.int64)), EPS)
    pert_j = jsample_pert(meta_j, cfg_j, seeds[0], EPS)
    assert set(pert_t.ij) == {"blk/w"} and set(pert_t.zv) == {"blk/b"}
    assert set(tplib.flatten(pert_j.zv)) == {"blk/b"}
    np.testing.assert_array_equal(pert_t.zv["blk/b"][0].numpy(),
                                  np.asarray(pert_j.zv["blk"]["b"]))
    ij_j = pert_j.ij["blk"]["w"]
    for a, b in zip(pert_t.ij["blk/w"], (ij_j.i, ij_j.j)):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
    # the dense MeZO draw: zeros where frozen
    z_t = tzo.mezo_z(stacked(), torch.as_tensor(seeds[:1].astype(np.int64)),
                     frozen=lambda p: p in frozen)
    z_j = tplib.flatten(jzo.mezo_z(tree_j, seeds[0],
                                   frozen=lambda p: p in frozen))
    for p in flat:
        np.testing.assert_array_equal(z_t[p][0].numpy(), np.asarray(z_j[p]),
                                      err_msg=p)
        assert (not np.any(z_t[p].numpy())) == (p in frozen)


def _jax_pod_run(build, arch, shape, mesh, pod, batches):
    """The JAX step jitted on ``mesh`` over ``batches``: (params, metrics per
    step)."""
    fn, _, in_sh, out_sh = build(arch, shape, mesh, pod)
    params, metrics = jtf.init_params(arch, 0), []
    with mesh:
        jitted = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
        for t, (tk, em) in enumerate(batches):
            params, m = jitted(params, {"tokens": jnp.asarray(tk),
                                        "embeds": jnp.asarray(em)},
                               jnp.int32(t))
            metrics.append(m)
    return tplib.flatten(jax.tree.map(np.asarray, params)), metrics


def _port_pod_run(build, arch, pod, batches):
    step, params, metrics = build(arch, pod), ttf.init_params(arch, 0), []
    for t, (tk, em) in enumerate(batches):
        params, m = step(params, {"tokens": torch.as_tensor(tk).long(),
                                  "embeds": torch.as_tensor(em)}, t)
        metrics.append(m)
    return params, metrics


def test_pod_train_steps_match_jax(monkeypatch):
    arch_j, arch_t = _pair(VL)
    mesh = make_host_mesh(1, 1)
    n, gb = 2, 4
    P = arch_t.frontend.n_embeds
    shape = InputShape("pod", seq=P + 9, global_batch=gb, kind="train")
    kw = dict(lr=1e-2, rank=4, tau=1, base_seed=3, n_clients=n)
    pod_j = jsteps.PodConfig(param_dtype=jnp.float32, kernel_backend="jnp",
                             **kw)
    pod_t = tsteps.PodConfig(**kw)
    assert tsteps.train_inputs(arch_t, shape.seq, gb, pod_t) == {
        k: v.shape for k, v in jsteps.train_inputs(arch_j, shape, mesh,
                                                   pod_j)[0].items()}
    made = tsteps.make_train_batch(arch_t, shape.seq, gb, pod_t, seed=1)
    assert made["tokens"].shape == (n, gb // n, 9)
    assert made["embeds"].shape == (n, gb // n, P, 32)
    toks, emb = _inputs(arch_j, n, gb // n, 9, 6)
    batches = [((toks + t) % arch_t.vocab, emb * (1 + t)) for t in range(2)]
    init = ttf.init_params(arch_t, 0)

    # SeedFlood: the JAX step's coefficients recorded from inside its jit
    coefs_j = []
    apply_j = jsub.apply_messages

    def recording(params, meta, cfg, sub, seeds, coefs):
        jax.debug.callback(lambda c: coefs_j.append(np.array(c)), coefs)
        return apply_j(params, meta, cfg, sub, seeds, coefs)

    monkeypatch.setattr(jsteps.subcge, "apply_messages", recording)
    want, mj = _jax_pod_run(jsteps.build_seedflood_train_step, arch_j, shape,
                            mesh, pod_j, batches)
    monkeypatch.undo()
    # ... and the port fed them, its own recorded beside
    coefs_t = []
    apply_t = tsub.apply_messages

    def fed(params, meta, cfg, sub, seeds, coefs):
        coefs_t.append(coefs[0].numpy())
        return apply_t(params, meta, cfg, sub, seeds,
                       torch.as_tensor(coefs_j[len(coefs_t) - 1])[None])

    monkeypatch.setattr(tsteps.subcge, "apply_messages", fed)
    got, mt = _port_pod_run(tsteps.build_seedflood_train_step, arch_t, pod_t,
                            batches)
    monkeypatch.undo()
    for t, (own, ref) in enumerate(zip(coefs_t, coefs_j, strict=True)):
        np.testing.assert_allclose(own, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=f"coefficients, step {t}")
        for k in ("loss", "alpha_rms"):
            np.testing.assert_allclose(float(mt[t][k]), float(mj[t][k]),
                                       rtol=RTOL, err_msg=(k, t))
    assert set(want) == set(got)
    for p, w in want.items():
        np.testing.assert_allclose(got[p].numpy(), w, rtol=0, atol=1e-6,
                                   err_msg=("seedflood", p))
    assert not torch.equal(got["frontend/proj"], init["frontend/proj"])

    # DSGD
    want, mj = _jax_pod_run(jsteps.build_dsgd_train_step, arch_j, shape,
                            mesh, pod_j, batches)
    got, mt = _port_pod_run(tsteps.build_dsgd_train_step, arch_t, pod_t,
                            batches)
    for t in range(2):
        np.testing.assert_allclose(float(mt[t]["loss"]), float(mj[t]["loss"]),
                                   rtol=RTOL, err_msg=("loss", t))
    for p, w in want.items():
        np.testing.assert_allclose(got[p].numpy(), w, rtol=0, atol=1e-6,
                                   err_msg=("dsgd", p))
    assert not torch.equal(got["frontend/proj"], init["frontend/proj"])
