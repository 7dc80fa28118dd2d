"""The port's zeroth-order baselines and the method registry against the JAX
package: ``central_zo`` (plain and with subspace momentum), ``gossip_sr``,
``dzsgd`` and ``dzsgd_lora``, each through
``repro_torch.dtrain.runner.run`` against the JAX Trainer on the same
config (a d32 one-layer decoder, 4 clients on a ring, 3 steps, rank 4,
τ = 2 so that momentum resets and gossip-SR's replay crosses an epoch).

Tolerances, as the SeedFlood parity tests (the Gaussians are bitwise, see
test_torch_prng; the gaps come from float32 summation order in the
forwards, which the finite difference (L+ − L−) / 2ε amplifies):

* byte ledger equal; gossip-SR's ``reconstructions`` equal;
* loss curve rtol 1e-4; every final parameter atol 3e-5;
* ``mezo_z``: bitwise; ``momentum_apply`` across a τ-refresh: atol 1e-6.

Also: the registry's names and ``consumes`` sets, and each rejection of
``validate_config``, against the JAX package's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import subcge as jsub, zo as jzo  # noqa: E402
from repro.core.transport import GossipSRTransport as JGossipSR  # noqa: E402
from repro.data.synthetic import TaskConfig as JTask  # noqa: E402
from repro.dtrain.api import sim_arch as jsim_arch  # noqa: E402
from repro.dtrain.methods import METHOD_SPECS as JSPECS  # noqa: E402
from repro.dtrain.runner import DTrainConfig as JConfig  # noqa: E402
from repro.dtrain.runner import validate_config as jvalidate  # noqa: E402
from repro_torch.core import subcge as tsub, zo as tzo  # noqa: E402
from repro_torch.core.transport import GossipSRTransport  # noqa: E402
from repro_torch.data.synthetic import TaskConfig  # noqa: E402
from repro_torch.dtrain.api import sim_arch  # noqa: E402
from repro_torch.dtrain.methods import METHOD_SPECS  # noqa: E402
from repro_torch.dtrain.runner import DTrainConfig, run, validate_config  # noqa: E402
from repro_torch.models import params as tplib  # noqa: E402
from repro_torch.topology import graphs  # noqa: E402

from _torch_parity import (assert_run_matches, jax_method_run,  # noqa: E402,F401
                           one_thread, subcge_pair, weights)

ARCH = dict(d_model=32, n_layers=1, n_heads=2, d_ff=64)
# a short test split keeps the final accuracy pass cheap; the training
# split comes first from the task's rng, so it is the default one
TASK = dict(vocab=256, n_valid=8, n_test=64)
RUN = dict(n_clients=4, steps=3, batch_size=2, local_iters=1, subcge_rank=4,
           subcge_tau=2)
#: the field the port's config does not have (it dispatches on the
#: device), left out of its ``consumes``; ``batched_step`` is the port's too
DROPPED = {"kernel_backend"}


def _runs(method, **kw):
    rj = jax_method_run(JConfig(method=method, arch=jsim_arch(**ARCH),
                                task=JTask(**TASK), **RUN, **kw))
    rt = run(DTrainConfig(method=method, arch=sim_arch(**ARCH),
                          task=TaskConfig(**TASK), device="cpu", **RUN, **kw))
    return rt, rj


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("method,kw", [
    ("central_zo", {}), ("central_zo", dict(momentum=0.9)), ("gossip_sr", {}),
    ("dzsgd", {}), ("dzsgd_lora", {})],
    ids=["central_zo", "central_zo-momentum", "gossip_sr", "dzsgd",
         "dzsgd_lora"])
def test_method_run_matches_jax(method, kw):
    rt, rj = _runs(method, **kw)
    assert_run_matches(rt, rj)
    assert rt.method == rj.method
    if method == "gossip_sr":
        assert rt.extra["reconstructions"] == rj.extra["reconstructions"] > 0
        assert rt.total_bytes > 0
    elif method == "central_zo":
        assert rt.total_bytes == 0 and rt.consensus_error == 0.0
        want = tplib.flatten(jax.tree.map(np.asarray, rj.extra["final_params"]))
        for p, w in want.items():
            np.testing.assert_allclose(rt.extra["final_params"][p].numpy(), w,
                                       atol=3e-5, err_msg=p)


def test_gossip_sr_exchange_matches_jax():
    """Three exchanges of coefficient histories on a ring of 6, built as
    the method builds them: the averaged histories are equal, key order
    included (it fixes the delta replay's summation order), and so is the
    ledger."""
    g = graphs.ring(6)
    W = graphs.metropolis_weights(g)
    tj, tt = JGossipSR(g, W, every=1), GossipSRTransport(g, W, every=1)
    rng = np.random.default_rng(8)
    hj, ht = [dict() for _ in range(6)], [dict() for _ in range(6)]
    for t in range(3):
        for i in range(6):
            entry = [int(rng.integers(2**32)), float(rng.standard_normal()), 1.0]
            hj[i][(i, t)] = list(entry)
            ht[i][(i, t)] = list(entry)
        hj = tj.exchange(hj, t, np.ones(6, bool))
        ht = tt.exchange(ht, t)
        for a, b in zip(ht, hj):
            assert list(a.items()) == list(b.items())
    assert (tt.ledger.total_bytes, tt.ledger.n_messages) == \
        (tj.ledger.total_bytes, tj.ledger.n_messages)


def test_mezo_z_is_bitwise():
    arch_j = jsim_arch(**ARCH)
    trees, stacked = weights(arch_j, 3)
    seeds = np.array([0, 12345, 2**32 - 1], np.uint32)
    got = tzo.mezo_z(stacked, torch.as_tensor(seeds.astype(np.int64)))
    assert set(got) == set(stacked)
    for c, s in enumerate(seeds):
        want = tplib.flatten(jax.tree.map(
            np.asarray, jzo.mezo_z(trees[c], jnp.uint32(s))))
        for p, w in want.items():
            assert got[p].shape == stacked[p].shape
            assert (got[p][c].numpy().view(np.int32) == w.view(np.int32)).all(), p
    # θ + s·z per client, s rounded to float32 first
    scale = torch.tensor([1e-3, -2e-3, 0.5])
    out = tzo.tree_add_scaled(stacked, got, scale)
    for c in range(3):
        want = tplib.flatten(jax.tree.map(np.asarray, jzo.tree_add_scaled(
            trees[c], jax.tree.map(jnp.asarray, tplib.to_numpy(
                {p: z[c] for p, z in got.items()})), float(scale[c]))))
        for p, w in want.items():
            np.testing.assert_allclose(out[p][c].numpy(), w, rtol=0,
                                       atol=1e-7, err_msg=p)


def test_momentum_apply_across_refresh():
    """Four steps of subspace momentum at τ = 3: the velocity is reset at
    step 3 and the subspace refreshed, as central_zo does."""
    arch_j = jsim_arch(**ARCH)
    meta_j, meta_t, cfg_j, cfg_t = subcge_pair(arch_j, sim_arch(**ARCH), 1e-3)
    trees, stacked = weights(arch_j, 1)
    pj = trees[0]
    vel_j = jsub.zero_buffers(meta_j, cfg_j)
    vel_t = tsub.zero_buffers(meta_t, cfg_t)
    assert set(vel_t) == set(vel_j)
    rng = np.random.default_rng(3)

    @jax.jit
    def jstep(p, vel, seeds, coefs, refresh_step):
        sub = jsub.make_subspace(meta_j, cfg_j, 5, refresh_step)
        return jsub.momentum_apply(p, meta_j, cfg_j, sub, vel, seeds, coefs,
                                   beta=0.9)

    for step in range(4):
        seeds = rng.integers(0, 2**32, 4, dtype=np.uint32)
        coefs = (1e-2 * rng.standard_normal(4)).astype(np.float32)
        if step == cfg_j.refresh_period:
            vel_j = {p: jnp.zeros_like(v) for p, v in vel_j.items()}
            vel_t = {p: torch.zeros_like(v) for p, v in vel_t.items()}
        sub_t = tsub.subspace_at_step(meta_t, cfg_t, 5, step)
        pj, vel_j = jstep(pj, vel_j, jnp.asarray(seeds), jnp.asarray(coefs),
                          jnp.int32(tsub.refresh_step(step, cfg_t)))
        stacked, vel_t = tsub.momentum_apply(
            stacked, meta_t, cfg_t, sub_t, vel_t,
            torch.as_tensor(seeds.astype(np.int64))[None],
            torch.as_tensor(coefs)[None], beta=0.9)
        for p, v in vel_j.items():
            np.testing.assert_allclose(vel_t[p][0].numpy(), np.asarray(v),
                                       rtol=0, atol=1e-6, err_msg=p)
    want = tplib.flatten(jax.tree.map(np.asarray, pj))
    for p, w in want.items():
        np.testing.assert_allclose(stacked[p][0].numpy(), w, rtol=0,
                                   atol=1e-6, err_msg=p)


def test_method_specs_match_jax():
    assert sorted(METHOD_SPECS) == sorted(JSPECS)
    for name, spec in METHOD_SPECS.items():
        assert spec.name == name
        assert spec.consumes == JSPECS[name].consumes - DROPPED, name
        assert spec.supports_churn == JSPECS[name].supports_churn, name


REJECTED = [("seedflood", "momentum", 0.9), ("dzsgd", "momentum", 0.5),
            ("dsgd", "choco_density", 0.1), ("gossip_sr", "choco_density", 0.1),
            ("dzsgd", "flood_k", 1), ("central_zo", "flood_backend", "numpy"),
            ("dsgd", "drain", True), ("choco", "lora_r", 4),
            ("dzsgd", "lora_alpha", 8.0), ("central_zo", "lora_r", 4)]


@pytest.mark.parametrize("method,field,value", REJECTED,
                         ids=[f"{m}-{f}" for m, f, _ in REJECTED])
def test_validate_config_rejects_like_jax(method, field, value):
    with pytest.raises(ValueError, match=field):
        jvalidate(JConfig(method=method, **{field: value}))
    with pytest.raises(ValueError, match=field):
        validate_config(DTrainConfig(method=method, **{field: value}))
    # a method that reads the field takes it, on both sides
    user = next(n for n, s in METHOD_SPECS.items() if field in s.consumes)
    jvalidate(JConfig(method=user, **{field: value}))
    validate_config(DTrainConfig(method=user, **{field: value}))


def test_unknown_method_is_a_key_error():
    with pytest.raises(KeyError):
        jvalidate(JConfig(method="sgd"))
    with pytest.raises(KeyError):
        validate_config(DTrainConfig(method="sgd"))
    with pytest.raises(KeyError):
        run(DTrainConfig(method="sgd", device="cpu"))
