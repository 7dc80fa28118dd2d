"""The port's bf16 paths against the JAX package, on the CPU, at function
level (no JAX pod step is compiled).

* The kernels' plain versions in bf16 (x, W and the update's W bf16; u, v,
  s, U, A and V float32) against the Pallas kernels run by the Pallas
  interpreter (``repro.kernels.ops`` with ``backend="interpret"``): equal,
  or one bf16 ulp apart — both accumulate in float32 and cast once, in
  different summation orders, so a sum that lands near a rounding boundary
  may round to the neighbouring bf16.
* ``init_params`` in bf16: bitwise ``repro.models.params.init_params(...,
  jnp.bfloat16)`` (both draw in float32 and round to nearest even).
* The buffer-mode functions (``accumulate_buffers``,
  ``apply_vector_messages``, ``fold_buffers``, ``effective_params``)
  against ``repro.core.subcge``'s, in float32 and bf16: the buffers
  bitwise (the same scatter in the same k order); the vector leaves
  bitwise in float32 and within one bf16 ulp in bf16 (XLA may keep the
  float32 update where the reference casts it, one rounding instead of
  two); the folds rtol 1e-6 in float32 (U A V^T summed in another order)
  and within one bf16 ulp in bf16.
* The port's buffer-mode pod step against its own fold-mode step (the
  reference's ``test_buffer_mode_matches_fold_mode``, on the port alone):
  the effective weights after 3 steps across a τ-refresh, float32, rtol
  2e-4 and atol 2e-5 as the reference holds its own.
* bf16 logits, MoE aux and ``lm_loss`` of a one-layer attention cut and a
  one-layer Mamba + MoE cut, unperturbed and at ±ε, against JAX's with the
  Pallas bodies: within 4 bf16 ulps of the largest logit, at most 5 % of
  the elements past one (limits set from a measured gap of 2.75 ulps and
  2.1 %; see the test), while ±ε move the logits by more.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.core import subcge as jsub  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import params as jplib, transformer as jtf  # noqa: E402
from repro.models.perturb import epoch_subspace as jepoch_subspace  # noqa: E402
from repro.models.perturb import Bundle as JBundle, _child as jchild  # noqa: E402
from repro.models.perturb import sample_pert as jsample_pert  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.core import subcge as tsub  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import params as tplib, transformer as ttf  # noqa: E402
from repro_torch.models.perturb import Bundle as TBundle  # noqa: E402
from repro_torch.models.perturb import epoch_subspace, sample_pert  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

BF16 = torch.bfloat16


def _ordered(t: torch.Tensor) -> torch.Tensor:
    """bf16 bits as integers in the order of the values (±0 both 0)."""
    b = t.view(torch.int16).to(torch.int32)
    return torch.where(b < 0, -(b & 0x7FFF), b)


def _ulps(got: torch.Tensor, want) -> int:
    """The largest distance in bf16 ulps between two bf16 tensors (``want``
    a JAX array or a tensor)."""
    if not isinstance(want, torch.Tensor):
        want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    assert got.dtype == BF16
    return int((_ordered(got) - _ordered(want.to(BF16))).abs().max())


def _bf16(rng, *shape, scale=1.0):
    """(float32 numpy, the bf16 tensor of it): both packages round the
    same float32 values to nearest even."""
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return a, torch.from_numpy(a).to(BF16)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("kernel", ["rank1_matmul", "rank1_matmul_t",
                                    "subcge_apply", "subcge_apply_epochs",
                                    "rank1_matmul_expert"])
def test_kernel_plain_bf16_matches_pallas(kernel):
    """Rows 1-5 of the port's kernel table: one plain bf16 call against the
    Pallas body in interpret mode, at small ragged shapes."""
    rng = np.random.default_rng(len(kernel))
    s = np.float32(1e-3)
    if kernel in ("rank1_matmul", "rank1_matmul_t"):
        M, K, N = 24, 64, 40
        xa, x = _bf16(rng, M, K)
        trans = kernel == "rank1_matmul_t"
        Wa, W = _bf16(rng, N, K, scale=K ** -0.5) if trans \
            else _bf16(rng, K, N, scale=K ** -0.5)
        u = _f32(rng, N) if trans else _f32(rng, K, scale=K ** -0.5)
        v = _f32(rng, K, scale=K ** -0.5) if trans else _f32(rng, N)
        want = getattr(jops, kernel)(
            jnp.asarray(xa, jnp.bfloat16), jnp.asarray(Wa, jnp.bfloat16),
            jnp.asarray(u), jnp.asarray(v), s, backend="interpret")
        got = getattr(tops, kernel)(x[None], W[None],
                                    torch.from_numpy(u)[None],
                                    torch.from_numpy(v)[None],
                                    torch.tensor([s]))[0]
    elif kernel == "rank1_matmul_expert":
        E, Mc, K, N = 3, 16, 64, 24
        xa, x = _bf16(rng, E, Mc, K)
        Wa, W = _bf16(rng, E, K, N, scale=K ** -0.5)
        u, v = _f32(rng, E, K, scale=K ** -0.5), _f32(rng, E, N)
        want = jops.rank1_matmul_expert(
            jnp.asarray(xa, jnp.bfloat16), jnp.asarray(Wa, jnp.bfloat16),
            jnp.asarray(u.T), jnp.asarray(v.T), s, backend="interpret")
        got = tops.rank1_matmul_expert(x[None], W[None],
                                       torch.from_numpy(u)[None],
                                       torch.from_numpy(v)[None],
                                       torch.tensor([s]))[0]
    else:
        E = 2 if kernel == "subcge_apply_epochs" else 1
        n, m, r = 40, 24, 4
        Wa, W = _bf16(rng, 2, n, m, scale=0.05)
        U, V = _f32(rng, E, n, r), _f32(rng, E, m, r)
        A = _f32(rng, E, 2, r, r, scale=1e-2)
        if E == 1:
            want = jops.subcge_apply(jnp.asarray(Wa, jnp.bfloat16), U[0],
                                     A[0], V[0], backend="interpret")
            got = tops.subcge_apply(W, *(torch.from_numpy(a[0])
                                         for a in (U, A, V)))
        else:
            want = jops.subcge_apply_epochs(jnp.asarray(Wa, jnp.bfloat16),
                                            U, A, V, backend="interpret")
            got = tops.subcge_apply_epochs(W, *(torch.from_numpy(a)
                                                for a in (U, A, V)))
        # the update moved W: most elements changed, by the same rounding
        assert int((got != W).sum()) > W.numel() // 2
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    assert got.shape == want.shape
    assert _ulps(got, want) <= 1


def test_init_params_bf16_is_bitwise_jax():
    """The reduced Falcon Mamba 7B: normal, zeros, ones, s4d and dt_bias
    leaves."""
    arch_j = jarchs.reduced(jarchs.get("falcon-mamba-7b"))
    arch_t = tarchs.reduced(tarchs.get("falcon-mamba-7b"))
    want = tplib.flatten(jplib.init_params(jtf.arch_spec(arch_j), 3,
                                           jnp.bfloat16))
    got = tplib.init_params(ttf.arch_spec(arch_t), 3, dtype=BF16)
    assert set(want) == set(got)
    for p, w in want.items():
        assert w.dtype == jnp.bfloat16 and got[p].dtype == BF16, p
        wb = np.asarray(w).view(np.int16)
        assert (got[p].view(torch.int16).numpy() == wb).all(), p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_buffer_functions_match_jax(dtype):
    """Two matrix leaves (one stacked over 2 layers), two vector leaves, a
    frozen matrix; 3 messages accumulated onto nonzero buffers."""
    shapes = {"a/w": ((2, 12, 20), 1), "a/b": ((2, 20), 1),
              "c": ((16, 8), 0), "d": ((8,), 0), "f": ((6, 4), 0)}
    meta_j = {p: jsub.LeafMeta(s, nb, p == "f")
              for p, (s, nb) in shapes.items()}
    meta_t = {p: tsub.LeafMeta(s, nb, p == "f")
              for p, (s, nb) in shapes.items()}
    cfg_j = jsub.SubCGEConfig(rank=4, refresh_period=2, kernel_backend="jnp")
    cfg_t = tsub.SubCGEConfig(rank=4, refresh_period=2)
    rng = np.random.default_rng(5)
    w32 = {p: _f32(rng, *s) for p, (s, _) in shapes.items()}
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, BF16)
    pj = jplib.nest({p: jnp.asarray(a, jd) for p, a in w32.items()})
    pt = {p: torch.from_numpy(a).to(td)[None] for p, a in w32.items()}
    bufs = {p: _f32(rng, *(meta_t[p].batch_shape + (4, 4)), scale=1e-2)
            for p in ("a/w", "c")}
    seeds = rng.integers(0, 2**32, 3, dtype=np.uint32)
    coefs = _f32(rng, 3, scale=1e-2)
    st, ct = torch.as_tensor(seeds.astype(np.int64))[None], \
        torch.from_numpy(coefs)[None]

    # the buffers: bitwise
    bj = jsub.accumulate_buffers({p: jnp.asarray(b) for p, b in bufs.items()},
                                 meta_j, cfg_j, jnp.asarray(seeds),
                                 jnp.asarray(coefs))
    bt = tsub.accumulate_buffers({p: torch.from_numpy(b)[None]
                                  for p, b in bufs.items()},
                                 meta_t, cfg_t, st, ct)
    assert set(bj) == set(bt) == {"a/w", "c"}
    for p in bj:
        assert (bt[p][0].numpy() == np.asarray(bj[p])).all(), p
        assert not (bt[p][0].numpy() == bufs[p]).all(), p

    # the vector leaves (the matrix and frozen leaves untouched)
    vj = tplib.flatten(jsub.apply_vector_messages(
        pj, meta_j, cfg_j, jnp.asarray(seeds), jnp.asarray(coefs)))
    vt = tsub.apply_vector_messages({p: t.clone() for p, t in pt.items()},
                                    meta_t, cfg_t, st, ct)
    for p in shapes:
        if p in ("a/b", "d"):
            if dtype == "float32":
                assert (vt[p][0].numpy() == np.asarray(vj[p])).all(), p
            else:
                assert _ulps(vt[p][0], vj[p]) <= 1, p
            assert not torch.equal(vt[p], pt[p]), p
        else:
            assert torch.equal(vt[p], pt[p]), p

    # the folds, under the subspace the buffers accumulated against
    sj = jsub.subspace_at_step(meta_j, cfg_j, 7, 1)
    stt = tsub.subspace_at_step(meta_t, cfg_t, 7, 1)
    fj = tplib.flatten(jsub.fold_buffers(pj, meta_j, sj, bj,
                                         backend="interpret"))
    ej = tplib.flatten(jsub.effective_params(pj, meta_j, sj, bj,
                                             backend="interpret"))
    ft = tsub.fold_buffers({p: t.clone() for p, t in pt.items()}, meta_t,
                           stt, bt, inplace=True)
    et = tsub.effective_params(pt, meta_t, stt, bt)
    for p in shapes:
        for got, want in ((ft[p][0], fj[p]), (et[p][0], ej[p])):
            if p not in bt:
                assert torch.equal(got, pt[p][0]), p
            elif dtype == "float32":
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-7, err_msg=p)
            else:
                assert _ulps(got, want) <= 1, p
    # effective_params copies the matrix leaves and shares the others
    assert et["d"] is pt["d"] and et["c"] is not pt["c"]
    assert not torch.equal(et["c"], pt["c"])


def test_buffer_mode_step_matches_fold_mode():
    """The reduced TinyLlama, 2 clients, τ = 2 (a fold at step 2), 3 steps
    in float32: buffer mode's effective weights (W + U A V^T under step 2's
    subspace) equal fold mode's weights."""
    cfg = tarchs.reduced(tarchs.get("tinyllama-1.1b"))
    meta = tplib.subcge_meta(ttf.arch_spec(cfg))
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 2, 16)))
    out = {}
    for mode in ("fold", "buffer"):
        pod = tsteps.PodConfig(param_dtype=torch.float32, rank=4, n_clients=2,
                               apply_mode=mode, lr=1e-2, tau=2)
        step = tsteps.build_seedflood_train_step(cfg, pod)
        params = ttf.init_params(cfg, 0, dtype=pod.param_dtype)
        state = (params, tsteps.init_buffers(cfg, pod)) if mode == "buffer" \
            else params
        losses = []
        for t in range(3):
            state, m = step(state, {"tokens": tokens}, t)
            losses.append(float(m["loss"]))
        if mode == "buffer":
            params, bufs = state
            assert all(bool(b.abs().sum() > 0) for b in bufs.values())
            sub = tsub.subspace_at_step(meta, pod.subcge(), pod.base_seed, 2)
            state = {p: t[0] for p, t in tsub.effective_params(
                {p: t[None] for p, t in params.items()}, meta, sub,
                bufs).items()}
        out[mode] = (state, losses)
    np.testing.assert_allclose(out["buffer"][1], out["fold"][1], rtol=2e-4)
    for p, w in out["fold"][0].items():
        np.testing.assert_allclose(out["buffer"][0][p].numpy(), w.numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=p)
    with pytest.raises(ValueError, match="apply_mode"):
        tsteps.PodConfig(apply_mode="lazy")


def _one_slot(a, name: str, slot: int):
    """``reduced(name)`` at d32 cut to one of its slots, one layer."""
    import dataclasses
    r = a.reduced(a.get(name), d_model=32)
    return dataclasses.replace(r, groups=(dataclasses.replace(
        r.groups[0], slots=(r.groups[0].slots[slot],), reps=1),))


def _ulp_of_max(t: torch.Tensor) -> float:
    """One bf16 ulp at the largest magnitude in ``t``."""
    return 2.0 ** (np.floor(np.log2(float(t.abs().max()))) - 7)


def test_bf16_lm_loss_matches_jax():
    """Two one-layer d32 cuts with random bf16 weights, against JAX with the
    Pallas bodies (interpret mode, the arithmetic the port's kernels
    follow), unperturbed and at ±ε for ε = 1e-3 (the reference's) and 3e-2:

    * the reduced Qwen1.5-0.5B's attention slot: QKV bias, tied logits
      (the TRANS path);
    * the reduced Jamba's Mamba + MoE slot: bf16 Mamba projections around
      the float32 scan, the experts' products and the bf16 combine.

    The perturbed leaves as the layers read them (``Bundle.embed``, ``matw``
    and ``vec``: the casts of u, v, s and the Gaussians to the leaf's type)
    are held bitwise.  The logits are not bitwise: the packages sum in other
    orders and bf16 activations round each difference to a whole ulp.  Over
    seeds 0-2 of these inputs the gap measured at most 2.75 bf16 ulps of
    the largest logit, with at most 98 of 4608 elements (2.1 %) more than
    one such ulp away; the losses at most 3.0e-4 and the aux losses 8.0e-5
    apart (relative).  The limits are 4 ulps every element, at most 5 % of
    the elements past one ulp, rtol 1e-3 for the losses and 5e-4 for aux.
    The perturbation is visible against those limits: at ε = 3e-2 the +ε
    and −ε logits are more than 4 ulps apart at over 80 % of the elements
    (measured 90 %), at ε = 1e-3 they differ at over 90 % (measured 95 %).
    One rounding more or less of one activation (Mamba's y, say) stays
    inside the logits' limits; the leaves' check is what pins those casts
    exactly."""
    for name, slot in (("qwen1.5-0.5b", 0), ("jamba-1.5-large-398b", 1)):
        _check_bf16_forward(name, slot)


def _perturbed_leaves_j(arch, params, sub, pert):
    """The JAX package's perturbed leaves of layer 0's slot and the token
    embedding, as its layers read them."""
    first = lambda t: jax.tree.map(lambda a: a[0], t)  # noqa: E731
    b = JBundle(first(params["g0"])["s0"], sub["g0"]["s0"],
                first(pert.ij["g0"])["s0"], first(pert.zv["g0"])["s0"],
                pert.scale)
    out = {}
    for k in b.p:
        if jchild(b.ij, k) is not None:
            out[k] = b.matw(k)
        elif jchild(b.zv, k) is not None:
            out[k] = b.vec(k)
    e = JBundle(params["embed"], sub["embed"], pert.ij["embed"],
                pert.zv["embed"], pert.scale)
    out["embed/tok"] = e.embed("tok", jnp.arange(arch.vocab)[None])
    return out


def _check_bf16_forward(name: str, slot: int) -> None:
    arch_j, arch_t = _one_slot(jarchs, name, slot), _one_slot(tarchs, name,
                                                               slot)
    assert arch_t.n_layers == 1
    rng = np.random.default_rng(0)
    w32 = jax.tree.map(lambda spec: (0.1 * rng.standard_normal(spec.shape)
                                     ).astype(np.float32),
                       jtf.arch_spec(arch_j))
    pj = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), w32)
    pt = {p: torch.from_numpy(a).to(BF16)[None]
          for p, a in tplib.flatten(w32).items()}
    toks = rng.integers(0, arch_j.vocab, (2, 9), dtype=np.int32)
    batch_j, toks_t = {"tokens": jnp.asarray(toks)}, torch.as_tensor(toks)[None]
    seed = np.uint32(12345)
    meta_j = jplib.subcge_meta(jtf.arch_spec(arch_j))
    meta_t = tplib.subcge_meta(ttf.arch_spec(arch_t))
    cfg_j = jsub.SubCGEConfig(rank=4, refresh_period=3,
                              kernel_backend="interpret")
    cfg_t = tsub.SubCGEConfig(rank=4, refresh_period=3)
    sub_j = jepoch_subspace(meta_j, cfg_j, 5, 4)
    sub_t = epoch_subspace(meta_t, cfg_t, 5, 4)
    pert_t = sample_pert(meta_t, cfg_t, torch.tensor([int(seed)]), 1.0)

    def run_j(scale):
        kw = {} if scale is None else {
            "sub": sub_j, "pert": jsample_pert(meta_j, cfg_j, seed, scale)}
        lg, _, aux = jtf.forward(arch_j, pj, batch_j, kernel_backend="interpret",
                                 **kw)
        loss = jtf.lm_loss(arch_j, pj, batch_j, kernel_backend="interpret",
                           **kw)
        leaves = {} if scale is None else _perturbed_leaves_j(arch_j, pj,
                                                              **kw)
        return lg, aux, loss, leaves
    run_pert, run_plain = jax.jit(run_j), jax.jit(lambda: run_j(None))

    logits = {}
    for scale in (None, 1e-3, -1e-3, 3e-2, -3e-2):
        kw = {} if scale is None else {"sub": sub_t,
                                       "pert": pert_t.with_scale(scale)}
        lg_j, aux_j, loss_j, leaves_j = run_plain() if scale is None \
            else run_pert(scale)
        for k, want in leaves_j.items():
            if k == "embed/tok":
                got = TBundle(pt, sub_t, kw["pert"], "embed/").embed(
                    "tok", torch.arange(arch_t.vocab)[None, None])[0]
            else:
                b = TBundle(pt, sub_t, kw["pert"], "g0/s0/", 0)
                got = (b.matw(k) if "g0/s0/" + k in kw["pert"].ij
                       else b.vec(k))[0]
            assert got.dtype == BF16 and got.shape == want.shape, k
            assert _ulps(got, want) == 0, (name, scale, k)
        lg_t, aux_t = ttf.forward(arch_t, pt, toks_t, **kw)
        loss_t = ttf.lm_loss(arch_t, pt, toks_t, **kw)
        assert lg_t.dtype == BF16 and loss_t.dtype == torch.float32
        want = torch.from_numpy(np.array(jnp.asarray(lg_j, jnp.float32)))
        got = lg_t[0].float()
        assert got.shape == want.shape
        ulp, gap = _ulp_of_max(want), (got - want).abs()
        assert float(gap.max()) <= 4 * ulp, (name, scale)
        assert int((gap > ulp).sum()) <= 0.05 * gap.numel(), (name, scale)
        np.testing.assert_allclose(float(loss_t[0]), float(loss_j),
                                   rtol=1e-3, err_msg=f"{name} {scale}")
        np.testing.assert_allclose(float(aux_t[0]), float(aux_j), rtol=5e-4,
                                   atol=0 if float(aux_j) else 1e-30)
        logits[scale] = got
    for eps, share, over in ((1e-3, 0.9, 0), (3e-2, 0.8, 4)):
        moved = (logits[eps] - logits[-eps]).abs()
        assert int((moved > over * _ulp_of_max(logits[eps])).sum()) \
            > share * moved.numel(), (name, eps)
