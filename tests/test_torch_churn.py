"""Churn in the port against the JAX package: the dynamic topology, both
flood engines' anti-entropy, and training runs under leave / rejoin and
partition / heal scripts.

* ``DynamicTopology`` and ``ChurnSchedule``: the same deltas, active masks,
  live edges, effective diameter and ``state_dict`` after every event;
  ``random_churn`` draws the same events from the same seed; ``ChurnConfig``
  resolves to the same script.
* Both flood engines: the same ``SyncReport``s, catch-up arrays, padded
  payloads (order included: it fixes the replay's summation order) and
  ledgers, step by step, across a ``state_dict`` reload from the JAX
  engine's state; offline clients cannot inject.
* The ledger ``chip_smoke.py``'s churn phase asserts (OPT-125M's 64 clients
  on the 8 x 8 mesh-grid), derived from the JAX ``FloodTransport`` alone.
* ``run`` (a d32 one-layer decoder; choco at the default d64 two-layer
  width, see ``GOSSIP_ARCH``; seedflood at d64 in
  ``test_torch_churn_width.py``): seedflood under churn on both engines
  with τ = 3 (the catch-up crosses an epoch), the ``epoch_replay=False``
  arm (and that it differs from the fixed replay), a checkpoint the JAX
  Trainer wrote resumed by the port, dzsgd and choco under churn (offline
  clients' leaves bitwise frozen), the static methods' refusal, and a full
  outage.

Tolerances: topology, flood state and ledgers equal; runs within
``assert_run_matches`` (ledger equal, loss rtol 1e-4, params atol 3e-5).
The JAX seedflood runs are compile-bound (~20 s each), so each is made
once per module and shared.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ChurnConfig as JChurnConfig  # noqa: E402
from repro.core.messages import Message as JMessage  # noqa: E402
from repro.core.transport import FloodTransport as JFloodTransport  # noqa: E402
from repro.core import flood as jflood  # noqa: E402
from repro.data.synthetic import TaskConfig as JTask  # noqa: E402
from repro.dtrain.api import sim_arch as jsim_arch  # noqa: E402
from repro.dtrain.runner import DTrainConfig as JConfig  # noqa: E402
from repro.dtrain.runner import validate_config as jvalidate  # noqa: E402
from repro.topology import dynamic as jdyn, graphs as jgraphs  # noqa: E402
from repro_torch.configs.base import ChurnConfig  # noqa: E402
from repro_torch.core import flood  # noqa: E402
from repro_torch.core.messages import CommLedger, Message  # noqa: E402
from repro_torch.core.transport import FloodTransport  # noqa: E402
from repro_torch.data.synthetic import TaskConfig  # noqa: E402
from repro_torch.dtrain.api import sim_arch  # noqa: E402
from repro_torch.dtrain.runner import DTrainConfig, run, validate_config  # noqa: E402
from repro_torch.topology import dynamic, graphs  # noqa: E402

from _torch_parity import (assert_run_matches, jax_method_run,  # noqa: E402,F401
                           one_thread)

pytestmark = pytest.mark.usefixtures("one_thread")

# what the JAX FloodTransport charges OPT-125M's 64 clients on the 8 x 8
# mesh-grid over 6 steps of chip_smoke.py's churn script: (messages, bytes,
# sync_bytes, n_syncs); chip_smoke.py asserts the port's run against it
LEDGER_MESHGRID64_CHURN_6STEPS = (82602, 668088, 15912, 18)

# (topology, n, script builder): the builder takes the ChurnSchedule class
SCRIPTS = {
    "leave_rejoin": ("ring", 8,
                     lambda CS: CS.leave_rejoin((2, 5), 1, 3)),
    "partition": ("meshgrid", 16,
                  lambda CS: CS.partition((range(0, 8), range(8, 16)), 1, 3)
                  + CS.leave_rejoin((5,), 2, 4)),
    "link_flap": ("ring", 8,
                  lambda CS: CS.link_flap(((0, 1), (4, 5)), 1, 2)
                  + CS.leave_rejoin((0,), 2, 3)),
    "random": ("meshgrid", 16,
               lambda CS: CS.random_churn(16, 12, 0.1, seed=3, outage=(1, 3),
                                          max_concurrent=2)),
}


def _events(sched):
    return [(e.step, e.kind, tuple(e.nodes), tuple(map(tuple, e.edges)),
             tuple(map(tuple, e.groups))) for e in sched.events]


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_dynamic_topology_matches_jax(name):
    topo, n, build = SCRIPTS[name]
    sj, st = build(jdyn.ChurnSchedule), build(dynamic.ChurnSchedule)
    assert _events(st) == _events(sj) and st.horizon == sj.horizon
    tj = jdyn.DynamicTopology(jgraphs.make(topo, n))
    tt = dynamic.DynamicTopology(graphs.make(topo, n))
    for t in range(sj.horizon + 2):
        dj = tj.apply_events(sj.events_at(t))
        dt = tt.apply_events(st.events_at(t))
        assert dataclasses.asdict(dt) == dataclasses.asdict(dj), t
        assert (tt.active_mask() == tj.active_mask()).all()
        assert tt.neighbors() == tj.neighbors()
        assert tt.live_edge_count() == tj.live_edge_count()
        assert tt.effective_diameter() == tj.effective_diameter()
        assert tt.is_connected() == tj.is_connected()
        assert tt.n_active() == tj.n_active()
        assert tt.state_dict() == tj.state_dict()
        if t == 1:
            # mid-script: a fresh topology loaded from the JAX state agrees
            fresh = dynamic.DynamicTopology(graphs.make(topo, n))
            fresh.load_state_dict(tj.state_dict())
            assert fresh.neighbors() == tj.neighbors()
            assert fresh.effective_diameter() == tj.effective_diameter()
    assert tt.active_mask().all()


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_random_churn_matches_jax(seed):
    kw = dict(n=16, steps=40, rate=0.05, seed=seed, outage=(2, 6),
              max_concurrent=3)
    sj = jdyn.ChurnSchedule.random_churn(**kw)
    st = dynamic.ChurnSchedule.random_churn(**kw)
    assert len(st) > 0 and _events(st) == _events(sj)


@pytest.mark.parametrize("kw", [
    dict(kind="leave_rejoin", nodes=(1, 2), leave_at=1, rejoin_at=4),
    dict(kind="link_flap", edges=((0, 1),), leave_at=2, rejoin_at=3),
    dict(kind="partition", groups=((0, 1, 2), (3, 4, 5)), leave_at=1,
         rejoin_at=2),
    dict(kind="random", n=8, steps=20, rate=0.1, seed=5, outage=(1, 4))],
    ids=lambda kw: kw["kind"])
def test_churn_config_resolves_like_jax(kw):
    st = dynamic.ChurnSchedule.from_config(ChurnConfig(**kw))
    sj = jdyn.ChurnSchedule.from_config(JChurnConfig(**kw))
    assert _events(st) == _events(sj)
    with pytest.raises(ValueError, match="unknown churn kind"):
        dynamic.ChurnSchedule.from_config(ChurnConfig(kind="flood"))


def _same_arrays(got, want, what):
    for g, w in zip(got, want, strict=True):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert (g == w).all(), what


def _ledger(net):
    return dataclasses.asdict(net.ledger)


@pytest.mark.parametrize("k", [None, 1], ids=["full", "k1"])
@pytest.mark.parametrize("backend", ["python", "numpy"])
@pytest.mark.parametrize("name", ["leave_rejoin", "partition", "link_flap"])
def test_flood_engines_under_churn_match_jax(name, backend, k):
    """Each step: churn (SyncReport, catch-up), injections by online
    clients, k rounds with the catch-up prepended; at step 2 the port's
    engine is replaced by a fresh one loaded from the JAX engine's
    ``state_dict``, and both go on in step."""
    topo, n, build = SCRIPTS[name]
    sj, st = build(jdyn.ChurnSchedule), build(dynamic.ChurnSchedule)
    nj = jflood.make_network(jgraphs.make(topo, n), backend)
    nt = flood.make_network(graphs.make(topo, n), backend)
    assert type(nt).__name__ == type(nj).__name__
    rng = np.random.default_rng(n)
    for t in range(sj.horizon + 3):
        if sj.events_at(t):
            rj = nj.apply_churn(sj.events_at(t))
            rt = nt.apply_churn(st.events_at(t))
            assert dataclasses.asdict(rt) == dataclasses.asdict(rj), t
        cj, ct = nj.drain_catchup_arrays(), nt.drain_catchup_arrays()
        for a, b in zip(ct, cj, strict=True):
            _same_arrays(a, b, f"catch-up at step {t}")
        act = nj.active_mask()
        assert (nt.active_mask() == act).all()
        seeds = rng.integers(0, 2**32, n, dtype=np.uint32)
        coefs = rng.standard_normal(n).astype(np.float32)
        for i in np.flatnonzero(act):
            kw = dict(seed=int(seeds[i]), coef=float(coefs[i]), origin=int(i),
                      step=t)
            nj.inject(int(i), JMessage(**kw))
            nt.inject(int(i), Message(**kw))
        if not act.all():
            off = int(np.flatnonzero(~act)[0])
            with pytest.raises(ValueError, match="offline"):
                nt.inject(off, Message(seed=1, coef=0.0, origin=off, step=t))
        hops = k if k is not None else nj.diameter
        assert nt.diameter == nj.diameter
        _same_arrays(nt.rounds_padded(hops, extra=ct),
                     nj.rounds_padded(hops, extra=cj), f"payload {t}")
        assert _ledger(nt) == _ledger(nj), t
        if t == 2:
            arrays, meta = nj.state_dict()
            mine_a, mine_m = nt.state_dict()
            assert mine_m == meta
            assert set(mine_a) == set(arrays)
            nt = flood.make_network(graphs.make(topo, n), backend)
            nt.load_state_dict(arrays, meta)
            nt.ledger = CommLedger(**_ledger(nj))
            assert nt.in_flight() == nj.in_flight()
    assert nt.in_flight() == nj.in_flight()
    for i in range(n):
        assert nt.seen_uids(i) == nj.seen_uids(i)
    for uid in list(nj.seen_uids(0))[:4]:
        assert nt.coverage(uid) == nj.coverage(uid)
    assert flood.staleness_bound(nt.diameter, 3) == \
        jflood.staleness_bound(nj.diameter, 3)


def _full_width_script(CS):
    """chip_smoke.py's churn phase: four clients of the 8 x 8 mesh-grid's
    middle leave at step 1 and rejoin at 4; the grid splits in halves at
    step 2 and heals at 3."""
    return (CS.leave_rejoin((18, 19, 26, 27), leave_at=1, rejoin_at=4)
            + CS.partition((range(0, 32), range(32, 64)), at=2, heal_at=3))


def test_full_width_churn_ledger_is_the_jax_transports():
    """The JAX FloodTransport alone, with no model, gives the pinned
    ledger; the port's transport gives the same payloads, and the rejoin
    step's catch-up spans three τ-epochs at τ = 2."""
    g = jgraphs.make("meshgrid", 64)
    tj = JFloodTransport(g, backend="auto")
    tt = FloodTransport(graphs.make("meshgrid", 64), backend="auto")
    sj, st = _full_width_script(jdyn.ChurnSchedule), \
        _full_width_script(dynamic.ChurnSchedule)
    epochs = {}
    for t in range(6):
        if sj.events_at(t):
            tj.apply_churn(sj.events_at(t))
            tt.apply_churn(st.events_at(t))
        act = tj.active_mask()
        msgs = [dict(seed=1000 * t + i, coef=0.5, origin=i, step=t)
                for i in range(64) if act[i]]
        ij = tj.exchange([(m["origin"], JMessage(**m)) for m in msgs], t, act)
        it = tt.exchange([(m["origin"], Message(**m)) for m in msgs], t, act)
        _same_arrays((it.seeds, it.coefs, it.steps),
                     (ij.seeds, ij.coefs, ij.steps), f"step {t}")
        epochs[t] = sorted(set((ij.steps[ij.steps >= 0] // 2).tolist()))
    want = (tj.ledger.n_messages, tj.ledger.total_bytes,
            tj.ledger.sync_bytes, tj.ledger.n_syncs)
    assert want == LEDGER_MESHGRID64_CHURN_6STEPS
    assert (tt.ledger.n_messages, tt.ledger.total_bytes,
            tt.ledger.sync_bytes, tt.ledger.n_syncs) == want
    assert type(tt.net).__name__ == "VectorFloodNetwork"
    assert epochs[4] == [0, 1, 2]
    assert tt.stats()["engine"] == "VectorFloodNetwork"


# -- training runs -------------------------------------------------------------

# the d32 one-layer decoder of the port's other method parity tests: at
# the default d64 two-layer width this run's packages end 1.3e-4 apart,
# past the 3e-5 parameter tolerance; test_torch_churn_width.py runs that
# width and shows the gap is the ZO coefficient's (float32 loss rounding
# over 2 eps): fed JAX's coefficients, the port ends 6e-8 from JAX
ARCH = dict(d_model=32, n_layers=1, n_heads=2, d_ff=64)
TASK = dict(vocab=256, n_valid=8, n_test=64)
SF_RUN = dict(n_clients=8, steps=6, batch_size=2, subcge_tau=3)


def _sf_script(CS):
    """Client 3 misses steps 1-3 (τ-epochs 0 and 1) and catches up at 4;
    the ring splits in halves at step 2 and heals at 3."""
    return (CS.leave_rejoin((3,), 1, 4)
            + CS.partition((range(0, 4), range(4, 8)), 2, 3))


_JAX_RUNS: dict = {}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("jax_ckpt")


def _jax_seedflood(backend, ckpt_dir, **kw):
    """The JAX seedflood churn run of ``backend`` (made once per module);
    the python engine's also writes checkpoints every 3 steps."""
    key = (backend, tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        ck = dict(checkpoint_every=3, checkpoint_dir=str(ckpt_dir)) \
            if backend == "python" and not kw else {}
        _JAX_RUNS[key] = jax_method_run(JConfig(
            arch=jsim_arch(**ARCH), task=JTask(**TASK), flood_backend=backend,
            churn=_sf_script(jdyn.ChurnSchedule), **SF_RUN, **ck, **kw))
    return _JAX_RUNS[key]


_PORT_RUNS: dict = {}


def _port_seedflood(backend, **kw):
    """The port's seedflood churn run of ``backend`` (made once per module:
    the plain python-engine run is both a parity run and the baseline the
    epoch_replay=False run must differ from)."""
    key = (backend, tuple(sorted(kw.items())))
    if key not in _PORT_RUNS:
        _PORT_RUNS[key] = run(DTrainConfig(
            arch=sim_arch(**ARCH), task=TaskConfig(**TASK),
            flood_backend=backend, churn=_sf_script(dynamic.ChurnSchedule),
            device="cpu", **SF_RUN, **kw))
    return _PORT_RUNS[key]


@pytest.mark.parametrize("backend", ["python", "numpy"])
def test_seedflood_churn_run_matches_jax(backend, ckpt_dir):
    rj = _jax_seedflood(backend, ckpt_dir)
    rt = _port_seedflood(backend)
    assert_run_matches(rt, rj)
    for k in ("n_messages", "sync_bytes", "n_syncs", "diameter"):
        assert rt.extra[k] == rj.extra[k], k
    assert rt.extra["n_syncs"] > 0
    np.testing.assert_allclose(rt.consensus_error, rj.consensus_error,
                               rtol=1e-3, atol=1e-12)


def test_epoch_replay_false_matches_jax_and_differs(ckpt_dir):
    rj = _jax_seedflood("python", ckpt_dir, epoch_replay=False)
    rt = _port_seedflood("python", epoch_replay=False)
    assert_run_matches(rt, rj)
    fixed = _port_seedflood("python")
    gap = max(float((rt.extra["final_stacked"][p]
                     - fixed.extra["final_stacked"][p]).abs().max())
              for p in fixed.extra["final_stacked"])
    # the receiver-step replay moves the weights by more than the parity
    # tolerance: the catch-up crosses a τ boundary
    assert gap > 3e-5


def test_jax_checkpoint_resumes_in_port(ckpt_dir):
    """The JAX Trainer's step-3 checkpoint of the python-engine run (a
    client offline, the partition healed, flood state mid-run), resumed by
    the port, ends within tolerance of the uninterrupted JAX run."""
    rj = _jax_seedflood("python", ckpt_dir)
    path = ckpt_dir / "step000003.npz"
    assert path.exists()
    rt = _port_seedflood("python", resume_from=str(path))
    assert_run_matches(rt, rj)
    assert rt.loss_curve[:3] == rj.loss_curve[:3]
    assert rt.extra["sync_bytes"] == rj.extra["sync_bytes"]


GOSSIP_RUN = dict(n_clients=4, steps=4, batch_size=2, local_iters=1)
# choco is first-order and runs at the default sim width; dzsgd's ZO
# coefficient drifts there as seedflood's does (4.9e-5 past the tolerance)
GOSSIP_ARCH = {"dzsgd": ARCH, "choco": {}}


@pytest.mark.parametrize("method", ["dzsgd", "choco"])
def test_gossip_churn_run_matches_jax(method):
    """Client 1 is offline for steps 1-2: the live-subgraph mixing matrix,
    live-edge charging and (choco) the masked innovations match JAX, and
    the offline client's leaves stay bitwise where step 0 left them."""
    kw = dict(GOSSIP_RUN, method=method)
    rj = jax_method_run(JConfig(
        arch=jsim_arch(**GOSSIP_ARCH[method]), task=JTask(**TASK),
        churn=jdyn.ChurnSchedule.leave_rejoin((1,), 1, 3), **kw))
    churn = dynamic.ChurnSchedule.leave_rejoin((1,), 1, 3)
    port = dict(arch=sim_arch(**GOSSIP_ARCH[method]), task=TaskConfig(**TASK),
                device="cpu")
    rt = run(DTrainConfig(churn=churn, **port, **kw))
    assert_run_matches(rt, rj)
    before = run(DTrainConfig(churn=churn, **port, **dict(kw, steps=1)))
    during = run(DTrainConfig(churn=churn, **port, **dict(kw, steps=3)))
    for p, t in before.extra["final_stacked"].items():
        assert torch.equal(during.extra["final_stacked"][p][1], t[1]), p
        assert not torch.equal(during.extra["final_stacked"][p][0], t[0]), p


@pytest.mark.parametrize("method", ["gossip_sr", "central_zo"])
def test_static_methods_refuse_churn_like_jax(method):
    with pytest.raises(ValueError) as ej:
        jvalidate(JConfig(method=method,
                          churn=jdyn.ChurnSchedule.leave_rejoin((1,), 1, 2)))
    with pytest.raises(ValueError) as et:
        validate_config(DTrainConfig(
            method=method, churn=dynamic.ChurnSchedule.leave_rejoin((1,), 1, 2)))
    assert str(et.value) == str(ej.value) == \
        f"method '{method}' does not support churn"


def test_full_outage_keeps_the_loss_finite():
    """Every client leaves at step 1 and rejoins at 3: nobody steps while
    offline, the logged loss carries the last value, and the run ends
    finite and in consensus."""
    r = run(DTrainConfig(
        arch=sim_arch(**ARCH), task=TaskConfig(**TASK), n_clients=4, steps=4, batch_size=2,
        churn=dynamic.ChurnSchedule.leave_rejoin(range(4), 1, 3),
        device="cpu"))
    assert all(np.isfinite(r.loss_curve))
    assert r.loss_curve[1] == r.loss_curve[2] == r.loss_curve[0]
    assert r.consensus_error < 1e-10
