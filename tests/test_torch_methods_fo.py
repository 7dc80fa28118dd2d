"""The port's first-order gossip baselines against the JAX package:
``dsgd``, ``choco``, ``dsgd_lora`` and ``choco_lora``, each through
``repro_torch.dtrain.runner.run`` against the JAX Trainer on the same
config (a d32 one-layer decoder, 4 clients on a ring, 3 steps; one case
gossips every 2 steps, ``local_iters=2``), ``dsgd`` through the reduced
Falcon Mamba (autograd through the scan's plain version, against
``jax.grad`` through the JAX layer's ``_ssm_chunked``), and the gossip and
LoRA pieces they run on.

Tolerances: byte ledger equal; loss curve rtol 1e-4; every final
parameter atol 3e-5 (the SeedFlood parity tests' tolerances; autograd and
XLA sum the gradients in other orders).  ``topk_compress`` on a stacked
leaf with ties: equal element for element; ``mix``, ``choco_round`` and
``lora.merge``: atol 1e-6 (float32 products summed in other orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.core import gossip as jgossip  # noqa: E402
from repro.data.synthetic import TaskConfig as JTask  # noqa: E402
from repro.dtrain import lora as jlora  # noqa: E402
from repro.dtrain.api import sim_arch as jsim_arch  # noqa: E402
from repro.dtrain.runner import DTrainConfig as JConfig  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.core import gossip as tgossip  # noqa: E402
from repro_torch.data.synthetic import TaskConfig  # noqa: E402
from repro_torch.dtrain import lora as tlora  # noqa: E402
from repro_torch.dtrain.api import sim_arch  # noqa: E402
from repro_torch.dtrain.runner import DTrainConfig, run  # noqa: E402
from repro_torch.models import params as tplib, transformer as ttf  # noqa: E402
from repro_torch.topology import graphs  # noqa: E402

from _torch_parity import (assert_run_matches, jax_method_run,  # noqa: E402,F401
                           one_thread, weights)

ARCH = dict(d_model=32, n_layers=1, n_heads=2, d_ff=64)
# a short test split keeps the final accuracy pass cheap; the training
# split comes first from the task's rng, so it is the default one
TASK = dict(vocab=256, n_valid=8, n_test=64)
RUN = dict(n_clients=4, steps=3, batch_size=2)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("method,every", [
    ("dsgd", 1), ("choco", 1), ("dsgd_lora", 1), ("choco_lora", 1),
    ("choco", 2)], ids=["dsgd", "choco", "dsgd_lora", "choco_lora",
                        "choco-every2"])
def test_method_run_matches_jax(method, every):
    kw = dict(RUN, method=method, local_iters=every)
    rj = jax_method_run(JConfig(arch=jsim_arch(**ARCH), task=JTask(**TASK),
                                **kw))
    rt = run(DTrainConfig(arch=sim_arch(**ARCH), task=TaskConfig(**TASK),
                          device="cpu", **kw))
    assert_run_matches(rt, rj)
    assert rt.method == rj.method == method
    # one exchange per `every` steps, each charged on all 2 x 4 directed edges
    assert rt.total_bytes > 0 and rt.total_bytes % (2 * 4 * (3 // every)) == 0
    np.testing.assert_allclose(rt.consensus_error, rj.consensus_error,
                               rtol=1e-3, atol=1e-12)


@pytest.mark.usefixtures("one_thread")
def test_dsgd_through_mamba_matches_jax():
    arch_j = jarchs.reduced(jarchs.get("falcon-mamba-7b"))
    arch_t = tarchs.reduced(tarchs.get("falcon-mamba-7b"))
    task = dict(TASK, vocab=arch_j.vocab)
    kw = dict(RUN, method="dsgd", steps=2, local_iters=1)
    rj = jax_method_run(JConfig(arch=arch_j, task=JTask(**task), **kw))
    rt = run(DTrainConfig(arch=arch_t, task=TaskConfig(**task), device="cpu",
                          **kw))
    assert_run_matches(rt, rj)


@pytest.mark.usefixtures("one_thread")
def test_dsgd_pod_step_bf16_means_in_float32():
    """The pod's DSGD step in bf16 (the reduced TinyLlama, 3 clients, lr
    0.5 so that the update shows in bf16): the clients' bf16 gradients are
    summed in float32 and divided by n before one cast, as the reference's
    ``jnp.mean`` over its vmapped bf16 gradients upcasts.  The step's
    weights equal those of that plain mean bitwise; a mean summed in bf16
    differs."""
    from repro_torch.launch import steps as tsteps
    cfg = tarchs.reduced(tarchs.get("tinyllama-1.1b"))
    pod = tsteps.PodConfig(lr=0.5, n_clients=3)
    assert pod.param_dtype == torch.bfloat16
    params = ttf.init_params(cfg, 0, dtype=pod.param_dtype)
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (3, 2, 16)))
    names = list(params)
    grads = []
    for i in range(3):
        leaves = [params[p].detach().requires_grad_(True) for p in names]
        loss = ttf.lm_loss(cfg, {p: t[None] for p, t in zip(names, leaves)},
                           tokens[i:i + 1])[0]
        grads.append(torch.autograd.grad(loss, leaves))
    want, bf16_mean_differs = {}, False
    for k, p in enumerate(names):
        g = [gi[k] for gi in grads]
        assert g[0].dtype == torch.bfloat16
        mean = ((g[0].float() + g[1] + g[2]) / 3).to(torch.bfloat16)
        bf16_mean_differs |= not torch.equal(mean, (g[0] + g[1] + g[2]) / 3)
        want[p] = params[p] - 0.5 * mean
    assert bf16_mean_differs
    before = {p: t.clone() for p, t in params.items()}
    got, m = tsteps.build_dsgd_train_step(cfg, pod)(params, {"tokens": tokens},
                                                     0)
    assert torch.isfinite(m["loss"])
    moved = 0
    for p in names:
        assert got[p].dtype == torch.bfloat16
        assert torch.equal(got[p], want[p]), p
        moved += int((got[p] != before[p]).sum())
    assert moved > sum(t.numel() for t in before.values()) // 4


def _stacked_leaf_with_ties():
    """(4, 5, 6) values on a grid of 0.25: many magnitudes tie."""
    rng = np.random.default_rng(11)
    return (0.25 * rng.integers(-6, 7, (4, 5, 6))).astype(np.float32)


@pytest.mark.parametrize("density", [0.01, 0.05, 0.3])
def test_topk_compress_keeps_ties_like_jax(density):
    x = _stacked_leaf_with_ties()
    want = np.asarray(jgossip.topk_compress(jnp.asarray(x), density))
    got = tgossip.topk_compress(torch.as_tensor(x), density).numpy()
    assert (got == want).all()
    k = max(1, int(x.size * density))
    assert np.count_nonzero(got) >= k
    if density == 0.05:
        # the top-k crosses the client axis, and ties keep more than k
        assert np.count_nonzero(got) > k
        assert len({c for c in range(4) if np.count_nonzero(got[c])}) > 1
    # tree_topk: the same, leaf by leaf
    tree = tgossip.tree_topk({"a": torch.as_tensor(x), "b": torch.as_tensor(
        x[:1])}, density)
    assert (tree["a"].numpy() == want).all()
    assert torch.equal(tree["b"], tgossip.topk_compress(torch.as_tensor(x[:1]),
                                                        density))


def _pair_trees(C, seed):
    trees, stacked = weights(jsim_arch(**ARCH), C, seed)
    jstacked = jax.tree.map(lambda *ls: jnp.stack(ls), *trees)
    return jstacked, stacked


def test_mix_matches_jax():
    W = graphs.metropolis_weights(graphs.ring(4))
    jst, tst = _pair_trees(4, 1)
    want = tplib.flatten(jax.tree.map(np.asarray, jgossip.mix(jst, W)))
    got = tgossip.mix(tst, W)
    for p, w in want.items():
        np.testing.assert_allclose(got[p].numpy(), w, rtol=0, atol=1e-6,
                                   err_msg=p)


def test_choco_round_matches_jax():
    """Two rounds from surrogates at other weights: the top-k innovation,
    the surrogate update and the (W − I) x̂ correction."""
    W = graphs.metropolis_weights(graphs.ring(4))
    jx, tx = _pair_trees(4, 2)
    jh, th = _pair_trees(4, 3)
    jstate, tstate = jgossip.ChocoState(x_hat=jh), tgossip.ChocoState(x_hat=th)
    for _ in range(2):
        jx, jstate = jgossip.choco_round(jx, jstate, W, 0.1)
        tx, tstate = tgossip.choco_round(tx, tstate, W, 0.1)
    for tree, got in ((jx, tx), (jstate.x_hat, tstate.x_hat)):
        for p, w in tplib.flatten(jax.tree.map(np.asarray, tree)).items():
            np.testing.assert_allclose(got[p].numpy(), w, rtol=0, atol=1e-6,
                                       err_msg=p)


def test_choco_init_copies():
    _, tx = _pair_trees(2, 4)
    state = tgossip.choco_init(tx)
    for p, t in tx.items():
        assert torch.equal(state.x_hat[p], t)
        assert state.x_hat[p].data_ptr() != t.data_ptr()


def test_lora_merge_matches_jax():
    """lora_spec on the wq / wv targets (r = 8), lora_init bitwise, and
    merge with nonzero B on stacked clients."""
    arch_j = jsim_arch(**ARCH)
    jspec = jlora.lora_spec(jtf.arch_spec(arch_j), r=8)
    tspec = tlora.lora_spec(ttf.arch_spec(sim_arch(**ARCH)), r=8)
    jflat = tplib.flatten(jspec)
    assert set(tspec) == set(jflat) == {
        f"g0/s0/{w}/{ab}" for w in ("wq", "wv") for ab in "AB"}
    for p, s in jflat.items():
        assert (tspec[p].shape, tspec[p].init, tspec[p].scale) == \
            (tuple(s.shape), s.init, s.scale), p
    want0 = tplib.flatten(jax.tree.map(np.asarray, jlora.lora_init(jspec, 1)))
    got0 = tlora.lora_init(tspec, 1)
    for p, w in want0.items():
        assert (got0[p].numpy().view(np.int32) == w.view(np.int32)).all(), p

    jbase, tbase = _pair_trees(2, 5)
    rng = np.random.default_rng(6)
    lora = {p: (0.1 * rng.standard_normal((2,) + s.shape)).astype(np.float32)
            for p, s in tspec.items()}
    want = tplib.flatten(jax.tree.map(np.asarray, jax.vmap(
        lambda b, lo: jlora.merge(b, lo, 16.0))(
            jbase, jax.tree.map(jnp.asarray, tplib.nest(lora)))))
    got = tlora.merge(tbase, {p: torch.as_tensor(v) for p, v in lora.items()},
                      16.0)
    assert set(got) == set(want)
    for p, w in want.items():
        np.testing.assert_allclose(got[p].numpy(), w, rtol=0, atol=1e-6,
                                   err_msg=p)
        if p.split("/")[-1] not in ("wq", "wv"):
            assert got[p] is tbase[p]
