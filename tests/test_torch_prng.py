"""The port's threefry PRNG and seed derivations against ``jax.random``.

Integer outputs (keys, bits, randint, coordinates, hashes, client seeds,
synthetic data, epoch slots) must be bitwise equal: they ARE the protocol.
float32 Gaussians are bitwise too: the port copies XLA CPU's ``log1p``,
``log`` and ``ErfInv`` rounding for rounding, so a torch client and a JAX
client on the CPU rebuild each other's perturbations bit for bit.  (JAX on
a GPU or TPU lowers ``log1p`` differently; the reference is JAX on the CPU.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import seeds as jseeds, subcge as jsub  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import params as jplib, transformer as jtf  # noqa: E402
from repro.dtrain.api import sim_arch as jsim_arch  # noqa: E402
from repro_torch.core import prng, seeds as tseeds, subcge as tsub  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.dtrain.api import sim_arch as tsim_arch  # noqa: E402
from repro_torch.models import params as tplib, transformer as ttf  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401

SEEDS = [0, 7, 123456789, 2**32 - 1, -1]
# largest gap allowed between prng.normal and jax.random.normal: none
MAX_NORMAL_ULP = 0


def _key(s):
    return jax.random.PRNGKey(jnp.asarray(s, jnp.uint32 if s >= 0 else jnp.int32))


def _np(x):
    return np.asarray(x).astype(np.int64)


def _ulp_gap(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_are_bitwise(seed):
    jk, tk = _key(seed), prng.PRNGKey(seed)
    assert (_np(jk) == tk.numpy()).all()
    for d in (0, 5, 2**31 + 3, 0xFFFFFFFF):
        assert (_np(jax.random.fold_in(jk, jnp.uint32(d)))
                == prng.fold_in(tk, d).numpy()).all()
    assert (_np(jax.random.split(jk, 3)) == prng.split(tk, 3).numpy()).all()
    assert (_np(jax.random.bits(jk, (5, 7), jnp.uint32))
            == prng.random_bits(tk, (5, 7)).numpy()).all()
    assert (np.asarray(jax.random.uniform(jk, (999,)))
            == prng.uniform(tk, (999,)).numpy()).all()


@pytest.mark.parametrize("span", [1, 3, 16, 1000, 2**20 + 7])
def test_randint_is_bitwise(span):
    for seed in SEEDS:
        ji = np.asarray(jax.random.randint(_key(seed), (3, 5), 0, span,
                                           jnp.int32))
        assert (ji == prng.randint(prng.PRNGKey(seed), (3, 5), 0,
                                   span).numpy()).all()


def test_batched_keys_match_one_by_one():
    keys = prng.fold_in(prng.PRNGKey(torch.arange(6)), 11)
    want = np.stack([_np(jax.random.fold_in(jax.random.PRNGKey(i), 11))
                     for i in range(6)])
    assert (keys.numpy() == want).all()


@pytest.mark.usefixtures("one_thread")
def test_normal_ulp_gap_is_pinned():
    """2^16 draws from each of 16 keys, all keys in one batched call per
    side (per key, the same draws as one call each)."""
    jn = jax.vmap(lambda k: jax.random.normal(k, (1 << 16,), jnp.float32))(
        jax.vmap(jax.random.PRNGKey)(jnp.arange(16)))
    tn = prng.normal(prng.PRNGKey(torch.arange(16)), (1 << 16,))
    assert tn.shape == jn.shape == (16, 1 << 16)
    assert _ulp_gap(jn, tn) <= MAX_NORMAL_ULP


@pytest.mark.usefixtures("one_thread")
def test_normal_is_bitwise_on_every_input():
    """All 2^23 inputs a float32 normal draw can take (the 23 mantissa bits
    of a word make its uniform): the port's transform against XLA CPU's
    ``sqrt(2) · erf_inv(uniform)`` of the same words, as
    ``jax.random.normal`` forms it (the replica is first held to
    ``jax.random.normal`` itself on 2^12 words of a real key)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))

    @jax.jit
    def jnormal_of_bits(bits):
        fb = jax.lax.shift_right_logical(bits, jnp.uint32(9)) \
            | jnp.uint32(0x3F800000)
        floats = jax.lax.bitcast_convert_type(fb, jnp.float32) - 1.0
        u = jax.lax.max(lo, floats * (np.float32(1.0) - lo) + lo)
        return jax.lax.mul(np.float32(np.sqrt(2)), jax.lax.erf_inv(u))

    key = _key(11)
    words = jax.random.bits(key, (1 << 12,), jnp.uint32)
    assert (np.asarray(jnormal_of_bits(words)).view(np.int32)
            == np.asarray(jax.random.normal(key, (1 << 12,))).view(
                np.int32)).all()
    bits = np.arange(1 << 23, dtype=np.uint32) << np.uint32(9)
    want = np.asarray(jnormal_of_bits(jnp.asarray(bits)))
    got = prng._normal_of_bits(torch.from_numpy(bits.astype(np.int64)))
    assert (got.numpy().view(np.int32) == want.view(np.int32)).all()


def test_log1p_matches_xla_cpu_bitwise():
    """XLA CPU's float32 log1p on 2^20 inputs of the range erf_inv feeds it
    (y = -x^2, x a normal draw's uniform), on both sides of the sqrt(2) - 1
    branch point, and on the edges (±0, -1, denormals, inf, nan)."""
    x = prng.uniform(prng.PRNGKey(3), (1 << 20,), prng._NORMAL_LO, 1.0)
    rng = np.random.default_rng(0)
    y = torch.cat([-x * x, torch.from_numpy(
        rng.uniform(-1.0, 3.0, 1 << 16).astype(np.float32)), torch.tensor(
        [0.0, -0.0, -1.0, 1e-45, -1e-45, 0.41421354, -0.41421357, np.inf,
         np.nan], dtype=torch.float32)])
    want = np.asarray(jnp.log1p(jnp.asarray(y.numpy())))
    got = prng.log1p_xla(y).numpy()
    assert (np.isnan(want) == np.isnan(got)).all()
    ok = ~np.isnan(want)
    assert (got[ok].view(np.int32) == want[ok].view(np.int32)).all()
    assert (np.abs(y.numpy()) >= 0.41421357).sum() > 1 << 18   # both branches
    # torch.log1p, which the port used before, is not XLA's
    assert (torch.log1p(y[:1 << 20]).numpy().view(np.int32)
            != want[:1 << 20].view(np.int32)).mean() > 0.01


def test_chunked_draws_equal_one_draw(monkeypatch):
    """random_bits / uniform / normal over chunks of the flat counter range
    (a chunk size that splits rows and keys unevenly) equal one draw."""
    keys = prng.PRNGKey(torch.tensor([0, 5, 2**32 - 1]))
    whole = [prng.random_bits(keys, (7, 11)), prng.uniform(keys, (7, 11)),
             prng.normal(keys, (7, 11))]
    monkeypatch.setattr(prng, "_CHUNK", 20)
    parts = [prng.random_bits(keys, (7, 11)), prng.uniform(keys, (7, 11)),
             prng.normal(keys, (7, 11))]
    for a, b in zip(whole, parts):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jn = np.asarray(jax.random.normal(_key(5), (7, 11), jnp.float32))
    assert _ulp_gap(jn, parts[2][1]) == 0


def test_seed_derivations_are_bitwise():
    for p in ("embed/tok", "g0/s0/wq", "g12/s3/ln_mlp_scale"):
        assert tseeds.path_hash(p) == jseeds.path_hash(p)
        for s in (0, 99):
            assert (_np(jseeds.subspace_key(s, 4, p))
                    == tseeds.subspace_key(s, 4, p).numpy()).all()
    # the epoch padding slot (-1) wraps to 0xFFFFFFFF on both sides
    assert (_np(jseeds.subspace_key(3, jnp.int32(jsub.EPOCH_PAD), "a/b"))
            == tseeds.subspace_key(3, tsub.EPOCH_PAD, "a/b").numpy()).all()
    with np.errstate(over="ignore"):      # uint32 wraparound is the contract
        assert (jseeds.client_seeds(5, 70000, 9)
                == tseeds.client_seeds(5, 70000, 9)).all()
    steps = np.array([[0, 1, 5, -1], [7, 8, -1, -1]], np.int32)
    for tau in (1, 2, 4):
        assert (jsub.epoch_slots(steps, jsub.SubCGEConfig(refresh_period=tau))
                == tsub.epoch_slots(steps,
                                    tsub.SubCGEConfig(refresh_period=tau))).all()


def test_coordinates_and_subspace_match_jax():
    spec_j = jtf.arch_spec(jsim_arch(d_model=32, n_layers=3, n_heads=2, d_ff=64))
    spec_t = ttf.arch_spec(tsim_arch(d_model=32, n_layers=3, n_heads=2, d_ff=64))
    meta_j, meta_t = jplib.subcge_meta(spec_j), tplib.subcge_meta(spec_t)
    assert {p: (m.shape, m.n_batch_dims) for p, m in meta_j.items()} == \
        {p: (m.shape, m.n_batch_dims) for p, m in meta_t.items()}
    cj = jsub.SubCGEConfig(rank=16, refresh_period=2)
    ct = tsub.SubCGEConfig(rank=16, refresh_period=2)
    seeds = np.array([0, 65536, 4294967295, 12345], np.uint32)
    coords_t = tsub.sample_coords(meta_t, ct, torch.as_tensor(seeds.astype(np.int64)))
    for k, s in enumerate(seeds):
        coords_j = jsub.sample_coords(meta_j, cj, s)
        for p, ij in coords_j.items():
            assert (np.asarray(ij.i) == coords_t[p][0][k].numpy()).all()
            assert (np.asarray(ij.j) == coords_t[p][1][k].numpy()).all()
    sub_j = jsub.subspace_at_step(meta_j, cj, 7, 5)
    sub_t = tsub.subspace_at_step(meta_t, ct, 7, 5)
    assert set(sub_j) == set(sub_t)
    for p, uv in sub_j.items():
        assert _ulp_gap(uv.U, sub_t[p][0]) <= MAX_NORMAL_ULP
        assert _ulp_gap(uv.V, sub_t[p][1]) <= MAX_NORMAL_ULP


def test_init_params_match_jax():
    arch_j = jsim_arch(d_model=32, n_layers=2, n_heads=2, d_ff=64)
    pj = tplib.flatten(jax.tree.map(np.asarray, jtf.init_params(arch_j, 3)))
    pt = ttf.init_params(tsim_arch(d_model=32, n_layers=2, n_heads=2,
                                   d_ff=64), 3)
    assert set(pj) == set(pt)
    for p in pj:
        # a scaled Gaussian: both sides round the same float32 product
        assert _ulp_gap(pj[p], pt[p]) <= MAX_NORMAL_ULP, p
    back = tplib.from_numpy(tplib.to_numpy(pt))
    assert all(torch.equal(back[p], pt[p]) for p in pt)


def test_synthetic_data_is_bitwise():
    for seed in (3, 4):
        tj = jsyn.TaskConfig(vocab=64, n_train=40, n_valid=8, n_test=8,
                             seed=seed)
        tt = tsyn.TaskConfig(vocab=64, n_train=40, n_valid=8, n_test=8,
                             seed=seed)
        dj, dt = jsyn.make_splits(tj), tsyn.make_splits(tt)
        for a, b in zip(dj, dt):
            assert (a.tokens == b.tokens).all() and (a.labels == b.labels).all()
        pj = jsyn.partition(dj[0], 4, seed=1)
        pt = tsyn.partition(dt[0], 4, seed=1)
        assert all((a == b).all() for a, b in zip(pj, pt))
        for step in (0, 3):
            bj = np.asarray(jsyn.stacked_batches(dj[0], pj, step, 3, 1)["tokens"])
            assert (bj == tsyn.stacked_batches(dt[0], pt, step, 3, 1)).all()


def _bf16_bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def test_bf16_uniform_and_gumbel_bitwise_on_every_word():
    """bf16 draws take 8-bit words (bf16 has 7 mantissa bits): the words
    are the low bytes of the 32-bit ones, and ``uniform`` (on [0, 1) and on
    [-3, 5)) and ``gumbel`` equal ``jax.random``'s bitwise on draws that
    cover all 256 words, the whole input space; the float32 draws of the
    same keys stay bitwise."""
    seen = set()
    for seed in (0, 7, 2**32 - 1):
        key, tkey = _key(seed), prng.PRNGKey(seed)
        b8 = np.asarray(jax.random.bits(key, (4096,), jnp.uint8))
        got = prng.random_bits(tkey, (4096,), width=8).numpy()
        np.testing.assert_array_equal(got, b8.astype(np.int64))
        seen.update(b8.tolist())
        for lo, hi in ((0.0, 1.0), (-3.0, 5.0)):
            want = jax.random.uniform(key, (4096,), jnp.bfloat16, lo, hi)
            got = prng.uniform(tkey, (4096,), lo, hi, dtype=torch.bfloat16)
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))
        want = jax.random.gumbel(key, (4096,), jnp.bfloat16)
        got = prng.gumbel(tkey, (4096,), torch.bfloat16)
        np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))
        for name in ("uniform", "gumbel"):
            want = np.asarray(getattr(jax.random, name)(key, (4096,)))
            got = getattr(prng, name)(tkey, (4096,)).numpy()
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
    assert seen == set(range(256))
    with pytest.raises(ValueError):
        prng.gumbel(prng.PRNGKey(0), (4,), torch.float16)


def test_bf16_categorical_is_bitwise_jax():
    """``categorical`` on bf16 logits draws bf16 Gumbels and argmaxes their
    bf16 sum, as ``jax.random.categorical`` does: 256 keys of the server's
    kind (fold_in(fold_in(PRNGKey(seed), rid), pos)), 1,000 bf16 logits a
    row divided by the temperature 0.8 in bf16, as the JAX server divides
    its bf16 logits.  Float32 Gumbels (the port before bf16 serving) give
    other tokens on most rows."""
    rng = np.random.default_rng(3)
    n, V = 256, 1000
    lg = jnp.asarray(rng.standard_normal((n, V)) * 2, jnp.bfloat16)
    rids, pos = np.arange(n) % 5, 16 + np.arange(n)
    key = jax.random.PRNGKey(0)
    jkeys = jax.vmap(lambda r, p: jax.random.fold_in(
        jax.random.fold_in(key, r), p))(jnp.asarray(rids), jnp.asarray(pos))
    want = np.asarray(jax.vmap(
        lambda k, row: jax.random.categorical(k, row / 0.8))(jkeys, lg))
    want = want.tolist()
    tl = torch.from_numpy(_bf16_bits(lg).astype(np.int16)).view(torch.bfloat16)
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(0), torch.as_tensor(rids)),
                        torch.as_tensor(pos))
    temp = float(torch.tensor(0.8, dtype=torch.bfloat16))
    got = prng.categorical(keys, tl / temp)
    assert got.tolist() == want
    f32_gumbels = torch.argmax(prng.gumbel(keys, (V,)) + (tl / temp).float(),
                               dim=-1)
    assert (f32_gumbels != got).sum() > n // 2
