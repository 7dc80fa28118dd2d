"""Shared inputs of the port's parity tests (``tests/test_torch_*.py``):
the same random weights on both sides, matching SubCGE settings, the JAX
Bundle of one layer, a JAX run that reports every method's final params
(and its SeedFlood coefficients), a port run that records or is fed them,
and the ``one_thread`` fixture.  Import it after
``pytest.importorskip("torch")``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import subcge as jsub
from repro.models import params as jplib, transformer as jtf
from repro.models.perturb import Bundle as JBundle, _child
from repro.models.perturb import sample_pert as jsample_pert
from repro_torch.core import subcge as tsub
from repro_torch.dtrain.methods import seedflood
from repro_torch.models import params as tplib, transformer as ttf


def weights(arch_j, C, seed=0):
    """Random numpy weights of the arch's shapes, one tree per client, and
    the port's stacked tensors of the same values."""
    rng = np.random.default_rng(seed)
    trees = [jax.tree.map(lambda spec: (0.1 * rng.standard_normal(spec.shape)
                                        ).astype(np.float32),
                          jtf.arch_spec(arch_j))
             for _ in range(C)]
    flat = [tplib.from_numpy(t) for t in trees]
    return trees, {p: torch.stack([f[p] for f in flat]) for p in flat[0]}


def subcge_pair(arch_j, arch_t, eps, rank=4):
    """(meta_j, meta_t, cfg_j, cfg_t): the two packages' SubCGE metadata and
    the same config (τ = 3; the JAX side on its ``jnp`` kernels)."""
    meta_j = jplib.subcge_meta(jtf.arch_spec(arch_j))
    meta_t = tplib.subcge_meta(ttf.arch_spec(arch_t))
    cfg_j = jsub.SubCGEConfig(rank=rank, refresh_period=3, eps=eps,
                              kernel_backend="jnp")
    cfg_t = tsub.SubCGEConfig(rank=rank, refresh_period=3, eps=eps)
    return meta_j, meta_t, cfg_j, cfg_t


def jax_slot_bundle(tree, meta_j, cfg_j, sub_j, seed, scale):
    """The JAX Bundle of layer 0, slot 0 of one client (what the scan body
    of ``transformer.forward`` builds); ``seed=None`` is unperturbed."""
    first = lambda t: jax.tree.map(lambda a: a[0], t)  # noqa: E731
    if seed is None:
        return JBundle(first(tree["g0"])["s0"], kb="jnp")
    pert = jsample_pert(meta_j, cfg_j, seed, scale)
    return JBundle(first(tree["g0"])["s0"], _child(_child(sub_j, "g0"), "s0"),
                   first(_child(pert.ij, "g0"))["s0"],
                   first(_child(pert.zv, "g0"))["s0"], pert.scale, "jnp")


@pytest.fixture
def one_thread():
    """Run the test on one torch thread, restored after.  Under pytest-xdist
    several workers share the cores, and torch's intra-op thread pool (one
    thread per core in every worker) then spends most of its time waiting at
    the barrier of each parallel op: a port run that takes 5 s alone took
    150 s beside five others, and 3.4 s on one thread.  One thread changes
    no draw, size or tolerance."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


#: the jitted pieces the JAX SeedFloodMethod's ``init`` builds, by what they
#: close over (see ``_share_seedflood_jits``)
_SEEDFLOOD_JITS: dict = {}


def _share_seedflood_jits(method, cfg) -> None:
    """Make ``method.init`` build its jitted pieces once per configuration
    they close over (the arch and SubCGE settings, through ``Setup``, the
    global seed and lr), and hand the same jits to later runs of equal
    configuration: a run that differs in flood engine, churn, steps or
    replay arm then reuses the compiled programs instead of compiling
    them again (jit retraces per new shape as usual).  The computation,
    and so the run's result, is the same as a fresh method's."""
    key = (repr(cfg.arch), cfg.subcge_rank, cfg.subcge_tau, cfg.eps,
           cfg.kernel_backend, cfg.seed, cfg.lr)
    init = method.init

    def shared_init(setup):
        if key not in _SEEDFLOOD_JITS:
            state = init(setup)
            _SEEDFLOOD_JITS[key] = {k: v for k, v in vars(method).items()
                                    if k.startswith("_") and callable(v)}
            return state
        method.n = cfg.n_clients
        method.meta, method.scfg = setup.meta, setup.scfg
        vars(method).update(_SEEDFLOOD_JITS[key])
        return setup.stacked

    method.init = shared_init


def jax_method_run(cfg, coefs: dict | None = None):
    """``repro.dtrain.runner.run`` of ``cfg`` through the JAX package's
    public Trainer (churn schedule included), with the method's
    ``params_of`` reported as
    ``extra["final_stacked"]`` (the JAX package reports final params for
    seedflood and central_zo only).  With ``coefs`` a dict, each step's
    SeedFlood coefficients go into ``coefs[t]`` (n_clients float32, 0 for
    a client that sent nothing).  SeedFlood runs of equal model settings
    share their compiled steps (``_share_seedflood_jits``)."""
    from repro.dtrain.api import Setup
    from repro.dtrain.methods import METHOD_SPECS
    from repro.dtrain.runner import _churn_schedule, validate_config
    from repro.dtrain.trainer import Trainer

    validate_config(cfg)
    spec = METHOD_SPECS[cfg.method]
    setup = Setup(cfg)
    method = spec.make_method(cfg)
    if cfg.method == "seedflood":
        _share_seedflood_jits(method, cfg)
    extra = method.result_extra
    method.result_extra = lambda st: {**extra(st),
                                      "final_stacked": method.params_of(st)}
    if coefs is not None:
        local_step = method.local_step

        def recording_step(state, batch, active, t):
            state, outbox = local_step(state, batch, active, t)
            coefs[t] = np.zeros(cfg.n_clients, np.float32)
            for i, msg in outbox.payload:
                coefs[t][i] = msg.coef
            return state, outbox

        method.local_step = recording_step
    return Trainer(cfg, setup, method, spec.make_transport(cfg, setup),
                   churn=_churn_schedule(cfg)).run()


def assert_run_matches(rt, rj, atol=3e-5, rtol=1e-4):
    """Ledger equal, loss curve within ``rtol``, every final stacked param
    within ``atol``."""
    assert rt.total_bytes == rj.total_bytes
    assert rt.bytes_per_edge == rj.bytes_per_edge
    np.testing.assert_allclose(rt.loss_curve, rj.loss_curve, rtol=rtol)
    want = tplib.flatten(jax.tree.map(np.asarray, rj.extra["final_stacked"]))
    got = rt.extra["final_stacked"]
    assert set(got) == set(want)
    for p, w in want.items():
        np.testing.assert_allclose(got[p].numpy(), w, atol=atol, err_msg=p)


def record_coefficients(monkeypatch, recorded: dict, fed: dict | None = None):
    """Record each port step's coefficients of online clients (0 for the
    others) into ``recorded``.  With ``fed``, each step uses those instead,
    the JAX run's: for its own update (``subcge.apply_messages``) and for
    the messages it floods.  The losses, and everything after the
    coefficient, stay the port's."""
    estimate = seedflood.SeedFloodMethod.estimate_and_update
    apply_messages = seedflood.subcge.apply_messages

    def estimate_with(self, stacked, tokens, seeds, step, active):
        on = torch.as_tensor(active)
        if fed is None:
            stacked, losses, coefs = estimate(self, stacked, tokens, seeds,
                                              step, active)
            recorded[step] = (coefs * on).numpy()
            return stacked, losses, coefs
        coefs = torch.from_numpy(fed[step]) * on

        def fed_apply(params, meta, scfg, sub, seeds_, own):
            return apply_messages(params, meta, scfg, sub, seeds_,
                                  coefs[:, None])

        with monkeypatch.context() as m:
            m.setattr(seedflood.subcge, "apply_messages", fed_apply)
            stacked, losses, _ = estimate(self, stacked, tokens, seeds, step,
                                          active)
        recorded[step] = coefs.numpy()
        return stacked, losses, coefs

    monkeypatch.setattr(seedflood.SeedFloodMethod, "estimate_and_update",
                        estimate_with)
