"""SeedFlood's per-client reference path (``batched_step=False``) in the
port against the JAX package, at step level (no JAX Trainer run), on a d32
one-layer ``sim_arch``:

* ``local_step`` + ``apply_inbox`` against JAX's per-client pieces at n = 8,
  one client offline, at a τ boundary with ``flood_k=1`` (the inbox holds
  messages of two τ-epochs, one client's row is empty): the losses within
  rtol 1e-5; fed JAX's α, every message equal (the JAX arm's numpy
  coefficient arithmetic); the leaves after the own update and after the
  replay within atol 1e-6 (float32 sums in other orders); the offline and
  the empty client untouched;
* the port's per-client run against its batched run at the JAX package's
  tolerances (tests/test_epoch_replay.py: losses and leaves atol 1e-6 after
  one step, leaves 1e-5 over two steps crossing τ = 2 with ``flood_k=1``),
  the ledger equal;
* ``validate_config`` against JAX's over every method × ``batched_step`` ×
  trace × churn × drain: the same accepted and refused.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import seeds as jseeds  # noqa: E402
from repro.core.transport import FloodInbox as JInbox  # noqa: E402
from repro.data.synthetic import TaskConfig as JTask  # noqa: E402
from repro.dtrain.api import Setup as JSetup, sim_arch as jsim_arch  # noqa: E402
from repro.dtrain.methods import METHOD_SPECS as JSPECS  # noqa: E402
from repro.dtrain.methods.seedflood import SeedFloodMethod as JSeedFlood  # noqa: E402
from repro.dtrain.runner import DTrainConfig as JConfig  # noqa: E402
from repro.dtrain.runner import validate_config as jvalidate  # noqa: E402
from repro.sim import TraceSet as JTraceSet  # noqa: E402
from repro.topology.dynamic import ChurnSchedule as JChurn  # noqa: E402
from repro_torch.core.transport import FloodInbox  # noqa: E402
from repro_torch.data.synthetic import TaskConfig  # noqa: E402
from repro_torch.dtrain.api import Setup, sim_arch  # noqa: E402
from repro_torch.dtrain.methods.seedflood import SeedFloodMethod  # noqa: E402
from repro_torch.dtrain.runner import DTrainConfig, run, validate_config  # noqa: E402
from repro_torch.models import params as tplib  # noqa: E402
from repro_torch.sim import TraceSet  # noqa: E402
from repro_torch.topology.dynamic import ChurnSchedule  # noqa: E402

from _torch_parity import one_thread, weights  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = dict(d_model=32, n_layers=1, n_heads=2, d_ff=64)
TASK = dict(vocab=256, n_valid=8, n_test=64)
N = 8


def _close(got: dict, want, atol: float, what: str) -> None:
    want = tplib.flatten(jax.tree.map(np.asarray, want))
    assert set(got) == set(want)
    for p, w in want.items():
        np.testing.assert_allclose(got[p].numpy(), w, rtol=0, atol=atol,
                                   err_msg=f"{what} {p}")


def test_per_client_pieces_match_jax(monkeypatch):
    kw = dict(n_clients=N, batch_size=2, subcge_rank=4, subcge_tau=2,
              flood_k=1, batched_step=False)
    cfg_j = JConfig(arch=jsim_arch(**ARCH), task=JTask(**TASK), **kw)
    cfg_t = DTrainConfig(arch=sim_arch(**ARCH), task=TaskConfig(**TASK),
                         device="cpu", **kw)
    mj, mt = JSeedFlood(cfg_j), SeedFloodMethod(cfg_t)
    mj.init(JSetup(cfg_j))
    mt.init(Setup(cfg_t))
    trees, stacked = weights(jsim_arch(**ARCH), N, seed=5)
    sj = jax.tree.map(lambda *ls: jnp.stack(ls), *trees)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 256, (N, 2, 17))
    active = np.ones(N, bool)
    active[3] = False
    t = 2                                    # the first step of epoch 2

    # (A) + (B): the own updates, fed JAX's α
    alphas_j, losses_j = mj._estimate_all(
        sj, jnp.asarray(toks), jnp.asarray(jseeds.client_seeds(0, t, N)), t)
    own = {}
    estimate = mt.estimate_all

    def fed(stacked_, tokens, seeds, step):
        own["alphas"], losses, sub = estimate(stacked_, tokens, seeds, step)
        return torch.tensor(np.asarray(alphas_j)), losses, sub

    monkeypatch.setattr(mt, "estimate_all", fed)
    sj1, out_j = mj.local_step(sj, {"tokens": jnp.asarray(toks)}, active, t)
    st1, out_t = mt.local_step({p: v.clone() for p, v in stacked.items()},
                               torch.as_tensor(toks), active, t)
    np.testing.assert_allclose(out_t.losses, np.asarray(out_j.losses),
                               rtol=1e-5)
    assert [(i, m.seed, m.coef, m.origin, m.step) for i, m in out_t.payload] \
        == [(i, m.seed, m.coef, m.origin, m.step) for i, m in out_j.payload]
    assert [i for i, _ in out_t.payload] == [i for i in range(N) if i != 3]
    scale = float(np.abs(np.asarray(losses_j)).max())
    np.testing.assert_allclose(own["alphas"].numpy(), np.asarray(alphas_j),
                               rtol=0, atol=2 * scale * 1e-5 / cfg_t.eps)
    _close(st1, sj1, 1e-6, "own update")
    for p in st1:
        assert torch.equal(st1[p][3], stacked[p][3]), p

    # (C): a replay of two τ-epochs' messages; client 5 received nothing
    K = 4
    seeds = rng.integers(0, 2**32, (N, K), dtype=np.uint32)
    coefs = (1e-3 * rng.standard_normal((N, K))).astype(np.float32)
    steps = rng.integers(1, 3, (N, K)).astype(np.int32)
    coefs[:, -1], steps[:, -1] = 0.0, -1     # padding
    coefs[5], steps[5] = 0.0, -1
    sj2 = mj.apply_inbox(sj, JInbox(seeds, coefs, steps, t))
    st2 = mt.apply_inbox({p: v.clone() for p, v in stacked.items()},
                         FloodInbox(seeds, coefs, steps, t))
    _close(st2, sj2, 1e-6, "replay")
    for p in st2:
        assert torch.equal(st2[p][5], stacked[p][5]), p
        assert not torch.equal(st2[p][0], stacked[p][0]), p


def _run(batched: bool, **kw):
    base = dict(n_clients=N, topology="ring", lr=1e-2, batch_size=4,
                subcge_rank=8, local_iters=2, arch=sim_arch(**ARCH),
                task=TaskConfig(**TASK), device="cpu")
    return run(DTrainConfig(**{**base, **kw}, batched_step=batched))


@pytest.mark.parametrize("kw,atol", [
    (dict(steps=1), 1e-6),
    (dict(steps=2, flood_k=1, subcge_tau=2), 1e-5)], ids=["one-step", "tau"])
def test_per_client_run_matches_batched(kw, atol):
    a, b = _run(True, **kw), _run(False, **kw)
    assert (a.total_bytes, a.extra["n_messages"]) == \
        (b.total_bytes, b.extra["n_messages"])
    np.testing.assert_allclose(b.loss_curve, a.loss_curve, rtol=0,
                               atol=1e-6 if kw["steps"] == 1 else 1e-4)
    for p, x in a.extra["final_stacked"].items():
        np.testing.assert_allclose(b.extra["final_stacked"][p].numpy(),
                                   x.numpy(), rtol=0, atol=atol, err_msg=p)


def test_validate_config_matches_jax():
    """Accepted and refused alike, by exception type, for every method ×
    batched_step × trace × churn × drain."""
    seen = set()
    for name, batched, traced, churned, drain in itertools.product(
            sorted(JSPECS), (True, False), (False, True), (False, True),
            (False, True)):
        kw = dict(method=name, n_clients=4, batched_step=batched, drain=drain)
        outcome = []
        for cfg in (JConfig(**kw,
                            trace=JTraceSet.constant(4) if traced else None,
                            churn=JChurn.leave_rejoin((1,), 1, 2)
                            if churned else None),
                    DTrainConfig(**kw,
                                 trace=TraceSet.constant(4) if traced
                                 else None,
                                 churn=ChurnSchedule.leave_rejoin((1,), 1, 2)
                                 if churned else None)):
            try:
                (jvalidate if isinstance(cfg, JConfig) else validate_config)(
                    cfg)
                outcome.append(None)
            except (KeyError, ValueError) as e:
                outcome.append(type(e))
        assert outcome[0] == outcome[1], (name, batched, traced, churned,
                                          drain, outcome)
        seen.add(outcome[0])
    assert seen == {None, ValueError}
