"""MeZO's dense-message path, the optimizers and the small helpers of the
port against the JAX package, at function level (no Trainer run), on a d32
one-layer ``sim_arch``:

* ``mezo_apply_messages`` for K in {1, 3, 8}, with and without a frozen
  predicate: bitwise (one message at a time, k ascending, the scale rounded
  to float32 first, as JAX's ``lax.scan``; the Gaussians are bitwise, see
  test_torch_prng);
* ``two_point_alpha`` / ``mezo_alpha``: the two losses within rtol 1e-5
  (float32 sums in other orders, as test_torch_model); α from JAX's two
  losses bitwise; ``zo_sgd_step`` fed JAX's α: bitwise;
* ``optim/sgd.py`` over five steps: plain SGD bitwise, with momentum
  within 1 float32 ulp of the parameters' scale; Adam within 8 ulps, and
  bitwise when fed JAX's bias corrections (XLA CPU's float32 ``pow`` of a
  0-dim count is one ulp off torch's at some counts);
  ``constant_lr`` / ``cosine_lr`` by ``==`` (the cosine is libm's ``cosf``,
  as XLA CPU's);
* ``fmt_bytes``, ``n_lora_params`` over every registered arch,
  ``RunResult.to_json`` (by ``json.dumps``), ``Message.nbytes``, the flood
  byte bounds, ``VectorFloodNetwork.round``, the seed helpers;
* ``subcge.materialize_z`` (bitwise), ``apply_A`` / ``delta_from_A`` (atol
  1e-6, as test_torch_model holds an update).
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.core import flood as jflood, messages as jmsg  # noqa: E402
from repro.core import seeds as jseeds, subcge as jsub, zo as jzo  # noqa: E402
from repro.dtrain import lora as jlora  # noqa: E402
from repro.dtrain.api import RunResult as JRunResult  # noqa: E402
from repro.dtrain.api import sim_arch as jsim_arch  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.topology import graphs as jgraphs  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.core import flood as tflood, messages as tmsg  # noqa: E402
from repro_torch.core import seeds as tseeds, subcge as tsub, zo as tzo  # noqa: E402
from repro_torch.dtrain import lora as tlora  # noqa: E402
from repro_torch.dtrain.api import RunResult, sim_arch  # noqa: E402
from repro_torch.models import params as tplib, transformer as ttf  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402
from repro_torch.topology import graphs as tgraphs  # noqa: E402

from _torch_parity import one_thread, subcge_pair, weights  # noqa: E402,F401

ARCH = dict(d_model=32, n_layers=1, n_heads=2, d_ff=64)
EPS = 1e-3


def _flat(tree) -> dict:
    return tplib.flatten(jax.tree.map(np.asarray, tree))


def _bitwise(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    assert got.shape == want.shape, what
    assert (got.numpy().view(np.int32) == want.view(np.int32)).all(), what


def _frozen(path: str) -> bool:
    return path.startswith("embed/") or path.endswith("w2")


@pytest.mark.usefixtures("one_thread")
def test_mezo_apply_messages_is_bitwise():
    trees, stacked = weights(jsim_arch(**ARCH), 2)
    rng = np.random.default_rng(1)
    f = jax.jit(jzo.mezo_apply_messages, static_argnums=3)
    for K in (1, 3, 8):
        seeds = rng.integers(0, 2**32, (2, K), dtype=np.uint32)
        coefs = (1e-2 * rng.standard_normal((2, K))).astype(np.float32)
        for frozen in (None, _frozen):
            got = tzo.mezo_apply_messages(
                {p: t.clone() for p, t in stacked.items()},
                torch.as_tensor(seeds.astype(np.int64)),
                torch.as_tensor(coefs), frozen)
            for c in range(2):
                want = _flat(f(trees[c], jnp.asarray(seeds[c]),
                               jnp.asarray(coefs[c]), frozen))
                for p, w in want.items():
                    _bitwise(got[p][c], w, f"K={K} {frozen} {p}")
                    if frozen is not None and frozen(p):
                        assert torch.equal(got[p][c], stacked[p][c])


@pytest.mark.usefixtures("one_thread")
def test_alphas_and_zo_sgd_step_match_jax(monkeypatch):
    arch_j, arch_t = jsim_arch(**ARCH), sim_arch(**ARCH)
    trees, stacked = weights(arch_j, 2)
    toks = np.random.default_rng(2).integers(0, 256, (2, 4, 17))
    seeds = np.array([7, 2**32 - 3], np.uint32)
    tt = torch.as_tensor(toks)

    def loss_t(p):
        return ttf.lm_loss(arch_t, p, tt)

    z = tzo.mezo_z(stacked, torch.as_tensor(seeds.astype(np.int64)))
    lp_t = loss_t(tzo.tree_add_scaled(stacked, z, EPS))
    lm_t = loss_t(tzo.tree_add_scaled(stacked, z, -EPS))
    plain = jax.jit(lambda p, tk: jtf.lm_loss(arch_j, p, {"tokens": tk}))
    lp_j, lm_j, a_j = [], [], []
    for c in range(2):
        def loss_j(p, c=c):
            return plain(p, toks[c])

        zj = jzo.mezo_z(trees[c], jnp.uint32(seeds[c]))
        lp_j.append(loss_j(jzo.tree_add_scaled(trees[c], zj, EPS)))
        lm_j.append(loss_j(jzo.tree_add_scaled(trees[c], zj, -EPS)))
        a_j.append(jzo.mezo_alpha(loss_j, trees[c], jnp.uint32(seeds[c]),
                                  EPS))
    lp_j, lm_j, a_j = (np.asarray(jnp.stack(v)) for v in (lp_j, lm_j, a_j))
    np.testing.assert_allclose(lp_t.numpy(), lp_j, rtol=1e-5)
    np.testing.assert_allclose(lm_t.numpy(), lm_j, rtol=1e-5)
    # α from JAX's two losses: the port's arithmetic, bitwise
    fed = iter([torch.tensor(lp_j), torch.tensor(lm_j)])
    _bitwise(tzo.two_point_alpha(lambda p: next(fed), stacked, z, EPS), a_j,
             "two_point_alpha")
    fed = iter([torch.tensor(lp_j), torch.tensor(lm_j)])
    _bitwise(tzo.mezo_alpha(lambda p: next(fed), stacked,
                            torch.as_tensor(seeds.astype(np.int64)), EPS),
             a_j, "mezo_alpha")
    # its own losses' α: the finite difference amplifies their rounding
    a_t = tzo.mezo_alpha(loss_t, stacked,
                         torch.as_tensor(seeds.astype(np.int64)), EPS)
    np.testing.assert_allclose(a_t.numpy(), a_j, rtol=0,
                               atol=2 * float(np.abs(lp_j).max()) * 1e-5 / EPS)
    # zo_sgd_step fed JAX's α
    lr = 5e-2
    monkeypatch.setattr(tzo, "two_point_alpha",
                        lambda *a: torch.tensor(a_j))
    new, alpha = tzo.zo_sgd_step(loss_t, stacked,
                                 torch.as_tensor(seeds.astype(np.int64)),
                                 EPS, lr)
    _bitwise(alpha, a_j, "alpha")
    for c in range(2):
        pj, aj = jzo.zo_sgd_step(lambda p, c=c: plain(p, toks[c]), trees[c],
                                 jnp.uint32(seeds[c]), EPS, lr)
        _bitwise(alpha[c:c + 1], np.asarray(aj)[None], "zo_sgd_step alpha")
        for p, w in _flat(pj).items():
            _bitwise(new[p][c], w, f"zo_sgd_step {p}")


def _ulps(got: torch.Tensor, want: np.ndarray) -> float:
    """Largest gap in float32 ulps of the array's largest magnitude."""
    scale = float(np.abs(want).max()) or 1.0
    return float(np.abs(got.numpy() - want).max()) / np.spacing(
        np.float32(scale))


def test_optim_matches_jax(monkeypatch):
    rng = np.random.default_rng(3)
    tree = {"a": {"w": rng.standard_normal((4, 5)).astype(np.float32)},
            "b": rng.standard_normal(7).astype(np.float32)}
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), tree) for _ in range(5)]

    def t_of(x):
        return jax.tree.map(torch.as_tensor, x)

    def gap(pt, pj):
        return max(_ulps(a, np.asarray(b)) for a, b in
                   zip(jax.tree.leaves(pt), jax.tree.leaves(pj)))

    for momentum, tol in ((0.0, 0), (0.9, 1)):
        sj, st = jsgd.sgd_init(tree, momentum), tsgd.sgd_init(t_of(tree),
                                                              momentum)
        pj, pt = tree, t_of(tree)
        for g in grads:
            pj, sj = jsgd.sgd_update(pj, g, sj, 0.05, momentum)
            pt, st = tsgd.sgd_update(pt, t_of(g), st, 0.05, momentum)
        assert gap(pt, pj) <= tol, momentum

    def adam():
        sj, st = jsgd.adam_init(tree), tsgd.adam_init(t_of(tree))
        pj, pt = tree, t_of(tree)
        for g in grads:
            pj, sj = jsgd.adam_update(pj, g, sj, 0.1)
            pt, st = tsgd.adam_update(pt, t_of(g), st, 0.1)
        assert gap(st.mu, sj.mu) == 0 and gap(st.nu, sj.nu) == 0
        assert int(st.count) == int(sj.count) == 5
        assert st.count.dtype == torch.int32
        return gap(pt, pj)

    # XLA CPU's float32 pow of the 0-dim count (b2 = 0.999 at counts 3, 6,
    # 7) is one ulp off torch's; the update's m / sqrt(v) carries that to
    # 8 ulps of the parameters' scale.  Fed JAX's 1 - b^count, bitwise.
    assert adam() <= 8
    monkeypatch.setattr(tsgd, "bias_correction", lambda b, c: torch.tensor(
        np.asarray(1 - b ** jnp.asarray(int(c), jnp.int32))))
    assert adam() == 0
    for args in ((0.1, 100, 0), (3e-4, 1000, 10), (1.0, 7, 2)):
        fj, ft = jsgd.cosine_lr(*args), tsgd.cosine_lr(*args)
        assert [ft(s) for s in range(args[1] + 3)] == \
            [fj(s) for s in range(args[1] + 3)]
    assert [tsgd.constant_lr(0.3)(s) for s in range(4)] == \
        [jsgd.constant_lr(0.3)(s) for s in range(4)]


def test_small_helpers_match_jax():
    sweep = [0, 1, -1, 1023.99, 1024, -1536, 2.5e6, -7.3e9, 1.1e12, 3e15,
             -5e18, 2**70, float("inf")]
    assert [tmsg.fmt_bytes(b) for b in sweep] == \
        [jmsg.fmt_bytes(b) for b in sweep]
    units = {tmsg.fmt_bytes(b).lstrip("-0123456789.inf") for b in sweep}
    assert units == {"B", "KB", "MB", "GB", "TB", "PB", "EB"}
    for name in jarchs.REGISTRY:
        lj = jlora.n_lora_params(jlora.lora_spec(jtf.arch_spec(
            jarchs.get(name)), r=8))
        lt = tlora.n_lora_params(tlora.lora_spec(ttf.arch_spec(
            tarchs.get(name)), r=8))
        assert lt == lj, name
    assert tmsg.Message(1, 0.5, 2, 3).nbytes == \
        jmsg.Message(1, 0.5, 2, 3).nbytes == tmsg.MESSAGE_BYTES

    # RunResult.to_json: the same contents in both packages
    common = dict(method="seedflood(k=3)", gmp=0.25, loss_curve=[5.5, 5.25],
                  acc_curve=[(2, 0.25)], bytes_per_edge=368.0,
                  total_bytes=2944.0, consensus_error=1e-12, wall_s=1.5,
                  compile_wall_s=0.5)
    big = np.arange(6, dtype=np.float32).reshape(2, 3)
    rj = JRunResult(**common, extra={
        "n_params": np.int64(7), "scalar": jnp.float32(0.5),
        "arr": jnp.asarray(big), "npf": np.float64(2.0), "flag": True,
        "none": None, "nested": {3: (np.int32(1), jnp.asarray([1, 2]))},
        "obj": jflood.FloodNetwork, "final_stacked": {"w": jnp.ones(3)},
        "final_params": {"w": jnp.ones(3)}})
    rt = RunResult(**common, extra={
        "n_params": np.int64(7), "scalar": torch.tensor(0.5),
        "arr": torch.as_tensor(big), "npf": np.float64(2.0), "flag": True,
        "none": None, "nested": {3: (np.int32(1), torch.tensor([1, 2]))},
        "obj": jflood.FloodNetwork, "final_stacked": {"w": torch.ones(3)},
        "final_params": {"w": torch.ones(3)}})
    assert json.dumps(rt.to_json()) == json.dumps(rj.to_json())
    assert "final_stacked" not in rt.to_json()["extra"]
    assert RunResult._JSON_DROP == JRunResult._JSON_DROP

    # the flood byte bounds and one round of the bitset engine
    for n in (4, 9, 16):
        gj, gt = jgraphs.make("meshgrid", n), tgraphs.make("meshgrid", n)
        assert tflood.flood_bytes_per_iteration(gt, n) == \
            jflood.flood_bytes_per_iteration(gj, n)
        assert tflood.gossip_sr_history_bytes(5, n, gt) == \
            jflood.gossip_sr_history_bytes(5, n, gj)
        nj, nt = jflood.VectorFloodNetwork(gj), tflood.VectorFloodNetwork(gt)
        for net, M in ((nj, jmsg.Message), (nt, tmsg.Message)):
            for i in range(n):
                net.inject(i, M(seed=100 + i, coef=0.1 * i, origin=i, step=0))
        for _ in range(3):
            got, want = nt.round(), nj.round()
            assert [[(m.seed, m.coef, m.origin, m.step) for m in r]
                    for r in got] == \
                [[(m.seed, m.coef, m.origin, m.step) for m in r]
                 for r in want]
        assert nt.ledger.total_bytes == nj.ledger.total_bytes

    # the seed helpers
    for args in ((0, 0, 0), (5, 3, 7), (2**32 - 1, 65535, 65535)):
        assert int(tseeds.client_seed(*args)) == \
            int(jseeds.client_seed(*args))
        assert tseeds.client_seed(*args).dtype == np.uint32
    assert (tseeds.client_seed(9, 4, np.arange(8))
            == jseeds.client_seeds(9, 4, 8)).all()
    for s in (0, 42, 2**32 - 1):
        assert tseeds.key_from_seed(s).numpy().astype(np.uint32).tolist() \
            == np.asarray(jseeds.key_from_seed(s)).tolist()
    spec_j = jtf.arch_spec(jsim_arch(**ARCH))
    spec_t = ttf.arch_spec(sim_arch(**ARCH))
    assert tseeds.tree_paths(spec_t) == jseeds.tree_paths(spec_j)
    assert list(tseeds.map_with_paths(lambda p, s: (p, s.shape),
                                      spec_t).values()) == \
        jax.tree.leaves(jseeds.map_with_paths(lambda p, s: (p, s.shape),
                                              spec_j),
                        is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.usefixtures("one_thread")
def test_subcge_helpers_match_jax():
    arch_j = jsim_arch(**ARCH)
    meta_j, meta_t, cfg_j, cfg_t = subcge_pair(arch_j, sim_arch(**ARCH), EPS)
    trees, stacked = weights(arch_j, 2)
    sub_j = jsub.subspace_at_step(meta_j, cfg_j, 5, 3)
    sub_t = tsub.subspace_at_step(meta_t, cfg_t, 5, 3)
    assert all(isinstance(uv, tsub.UV) for uv in sub_t.values())
    seeds = np.array([11, 2**31 + 5], np.uint32)
    z_t = tsub.materialize_z(stacked, meta_t, cfg_t, sub_t,
                             torch.as_tensor(seeds.astype(np.int64)))
    coords = tsub.sample_coords(meta_t, cfg_t,
                                torch.as_tensor(seeds.astype(np.int64)))
    assert all(isinstance(ij, tsub.IJ) for ij in coords.values())
    for c in range(2):
        want = _flat(jsub.materialize_z(trees[c], meta_j, cfg_j, sub_j,
                                        jnp.uint32(seeds[c])))
        for p, w in want.items():
            _bitwise(z_t[p][c], w, f"materialize_z {p}")
    rng = np.random.default_rng(4)
    path = "g0/s0/w1"
    A = (1e-2 * rng.standard_normal((1, cfg_t.rank, cfg_t.rank))).astype(
        np.float32)
    uv_j, uv_t = sub_j[path], sub_t[path]
    leaf = stacked[path][0]
    got = tsub.apply_A(leaf, uv_t, torch.as_tensor(A))
    want = np.asarray(jsub.apply_A(jnp.asarray(leaf.numpy()), uv_j,
                                   jnp.asarray(A), backend="jnp"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert not torch.equal(got, leaf)
    d_t = tsub.delta_from_A(uv_t, torch.as_tensor(A), torch.float32)
    d_j = np.asarray(jsub.delta_from_A(uv_j, jnp.asarray(A), jnp.float32,
                                       backend="jnp"))
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=0, atol=1e-6)
    assert math.isclose(float(d_t.abs().max()), float(np.abs(d_j).max()),
                        rel_tol=1e-5)
