"""The port's model and SubCGE updates against the JAX package, on the same
weights (carried across with ``params.from_numpy``).

* ``lm_loss`` without a perturbation and at ±ε, on the small ``sim_arch``,
  the reduced Qwen1.5-0.5B (QKV bias), the reduced Gemma 3 1B (gated
  tanh-gelu, window 16 at 33 tokens), a two-group mini Gemma built the
  same way in both packages (local, local, global, then local; window 8;
  head_dim 64 at d64 with 2 heads) and the reduced Qwen2-72B (QKV bias,
  untied head): rtol 1e-5 — float32 matmuls summed in different orders
  (each side's own Gaussian subspace is bitwise the other's,
  test_torch_prng).
* ``apply_messages`` and ``apply_messages_epoch`` with seeds, coefficients
  and sender steps made for the JAX side, crossing a τ boundary: params
  allclose at atol 1e-6 — an update is coef·U A V^T with coef ~1e-2, summed
  in a different order on each side.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs, base as jbase  # noqa: E402
from repro.core import subcge as jsub  # noqa: E402
from repro.dtrain.api import sim_arch as jsim_arch  # noqa: E402
from repro.models import params as jplib, transformer as jtf  # noqa: E402
from repro.models.perturb import epoch_subspace as jepoch_subspace  # noqa: E402
from repro.models.perturb import sample_pert as jsample_pert  # noqa: E402
from repro_torch.configs import archs as tarchs, base as tbase  # noqa: E402
from repro_torch.core import subcge as tsub  # noqa: E402
from repro_torch.dtrain.api import sim_arch as tsim_arch  # noqa: E402
from repro_torch.models import params as tplib, transformer as ttf  # noqa: E402
from repro_torch.models.perturb import epoch_subspace, sample_pert  # noqa: E402

from _torch_parity import one_thread, subcge_pair, weights  # noqa: E402,F401

EPS = 1e-3
SEEDS = np.array([12345, 4294967295], np.uint32)


def _mini_gemma(base, name):
    """Gemma 3's pattern at d64 in one package (``base``: its configs.base):
    two local slots and a global one, then one local; window 8, 2 heads
    of 64 over one kv head (head_dim is not d / H)."""
    local = base.dense_layer(64, 2, 1, 128, head_dim=64, window=8)
    glob = base.dense_layer(64, 2, 1, 128, head_dim=64)
    return base.ArchConfig(
        name=name, family="dense", d_model=64, vocab=256,
        groups=(base.Group((local, local, glob), 1), base.Group((local,), 1)),
        act="gelu", tie_embeddings=True, rope_theta=1e6, max_seq=128)


def _archs(name):
    if name == "sim":
        kw = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64)
        return jsim_arch(**kw), tsim_arch(**kw)
    if name == "gemma-mini":
        return _mini_gemma(jbase, name), _mini_gemma(tbase, name)
    reg = {"qwen-reduced": "qwen1.5-0.5b", "gemma-reduced": "gemma3-1b",
           "qwen2-reduced": "qwen2-72b"}[name]
    return jarchs.reduced(jarchs.get(reg)), tarchs.reduced(tarchs.get(reg))


def _stack(trees):
    return jax.tree.map(lambda *ls: jnp.stack(ls), *trees)


@pytest.mark.parametrize("name", ["sim", "qwen-reduced", "gemma-reduced",
                                  "gemma-mini", "qwen2-reduced"])
def test_lm_loss_matches_jax(name, one_thread):
    arch_j, arch_t = _archs(name)
    C = len(SEEDS)
    trees, stacked = weights(arch_j, C)
    # Gemma's windows (16 reduced, 8 mini) bind at 33 tokens
    T = 33 if name.startswith("gemma") else 9
    toks = np.random.default_rng(1).integers(0, arch_j.vocab, (C, 2, T),
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


def test_apply_messages_match_jax():
    arch_j, arch_t = _archs("sim")
    C, K, tau = 2, 4, 2
    trees, stacked = weights(arch_j, C)
    # one leaf of each kind: matrix / vector, unstacked / stacked over layers
    keep = ("embed/tok", "embed/ln_f_scale", "g0/s0/wq", "g0/s0/ln_attn_scale")
    trees = [tplib.nest({p: tplib.flatten(t)[p] for p in keep}) for t in trees]
    stacked = {p: stacked[p] for p in keep}
    meta_j = {p: m for p, m in jplib.subcge_meta(jtf.arch_spec(arch_j)).items()
              if p in keep}
    meta_t = {p: m for p, m in tplib.subcge_meta(ttf.arch_spec(arch_t)).items()
              if p in keep}
    cfg_j = jsub.SubCGEConfig(rank=4, refresh_period=tau, eps=EPS,
                              kernel_backend="jnp")
    cfg_t = tsub.SubCGEConfig(rank=4, refresh_period=tau, eps=EPS)
    rng = np.random.default_rng(2)
    seeds = rng.integers(0, 2**32, (C, K), dtype=np.uint32)
    coefs = (0.01 * rng.standard_normal((C, K))).astype(np.float32)
    # sender steps straddle the τ boundary at 4; -1 is payload padding
    steps = np.array([[3, 4, 5, -1], [2, 3, 3, 4]], np.int32)
    coefs[0, 3] = 0.0
    epochs = jsub.epoch_slots(steps, cfg_j)
    assert (epochs == tsub.epoch_slots(steps, cfg_t)).all()

    own = {p: t.clone() for p, t in stacked.items()}
    tsub.apply_messages(own, meta_t, cfg_t,
                        tsub.subspace_at_step(meta_t, cfg_t, 9, 5),
                        torch.as_tensor(seeds[:, :1].astype(np.int64)),
                        torch.as_tensor(coefs[:, :1]))
    tsub.apply_messages_epoch(stacked, meta_t, cfg_t, 9,
                              torch.as_tensor(seeds.astype(np.int64)),
                              torch.as_tensor(coefs), torch.as_tensor(steps),
                              epochs)
    own_j = jax.jit(lambda p, sd, cf: jsub.apply_messages(
        p, meta_j, cfg_j, jsub.subspace_at_step(meta_j, cfg_j, 9, 5), sd, cf))
    epoch_j = jax.jit(lambda p, sd, cf, st: jsub.apply_messages_epoch(
        p, meta_j, cfg_j, 9, sd, cf, st, jnp.asarray(epochs)))
    want_own = _stack([own_j(trees[c], seeds[c, :1], coefs[c, :1])
                       for c in range(C)])
    want = _stack([epoch_j(trees[c], seeds[c], coefs[c], steps[c])
                   for c in range(C)])
    for got_t, want_t in ((own, want_own), (stacked, want)):
        flat = tplib.flatten(jax.tree.map(np.asarray, want_t))
        for p, w in flat.items():
            np.testing.assert_allclose(got_t[p].numpy(), w, rtol=0, atol=1e-6,
                                       err_msg=p)
