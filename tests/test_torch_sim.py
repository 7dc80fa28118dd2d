"""The port's event engine (``repro_torch.sim``) against the JAX package's
``repro.sim``, and the port's own sync ≡ async oracle.

* ``TraceSet``: ``finish_time``, ``edge_delay``, ``ref_step_s``, the
  builders, JSON (dict, file, ``as_trace``) and the validation messages,
  on seeded traces with straggle and preempt episodes, equal to JAX's by
  ``==`` (virtual time is compared exactly, never with a tolerance);
  ``barrier_schedule``, ``time_to_loss`` and the ``EventQueue``'s pop
  order under permuted insertion, likewise.
* Every trace rule of ``validate_config``, case for case as the JAX
  package's ``tests/test_sim.py`` lists them, with JAX's message.
* The port's oracle: with ``TraceSet.constant`` the event run equals the
  synchronous run bitwise (seedflood under churn against ``drain=True``;
  dzsgd), and a lognormal run does not depend on the order its first
  events were queued in.

Runs use the d32 one-layer decoder of the other port run tests.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dtrain.runner import DTrainConfig as JConfig  # noqa: E402
from repro.dtrain.runner import validate_config as jvalidate  # noqa: E402
from repro import sim as jsim  # noqa: E402
from repro.sim import events as jevents  # noqa: E402
from repro.topology.dynamic import ChurnSchedule as JChurn  # noqa: E402
from repro_torch import sim  # noqa: E402
from repro_torch.data.synthetic import TaskConfig  # noqa: E402
from repro_torch.dtrain.api import Setup, sim_arch  # noqa: E402
from repro_torch.dtrain.methods import METHOD_SPECS  # noqa: E402
from repro_torch.dtrain.runner import DTrainConfig, run, validate_config  # noqa: E402
from repro_torch.sim import events  # noqa: E402
from repro_torch.topology.dynamic import ChurnSchedule  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = dict(d_model=32, n_layers=1, n_heads=2, d_ff=64)
TASK = dict(vocab=256, n_valid=8, n_test=64)


def _episodes(pkg, rng, n):
    """Up to three non-overlapping straggle / preempt episodes per client."""
    out = []
    for i in range(n):
        t = 0.0
        for _ in range(int(rng.integers(0, 4))):
            t0 = t + float(rng.uniform(0.0, 3.0))
            t1 = t0 + float(rng.uniform(0.1, 4.0))
            if rng.random() < 0.5:
                out.append(pkg.Episode(i, t0, t1, "preempt"))
            else:
                out.append(pkg.Episode(i, t0, t1, "straggle",
                                       float(rng.uniform(1.0, 5.0))))
            t = t1
    return tuple(out)


def _trace(pkg, case, seed):
    T = pkg.TraceSet
    if case == "lognormal":
        return T.lognormal(7, median_s=0.7, sigma=0.9, seed=seed,
                           bandwidth_bps=1e8, latency_s=0.003)
    if case == "two_speed":
        return T.two_speed(5, fast_s=0.5, slow_s=3.0, bandwidth_bps=1e9,
                           latency_s=0.01)
    if case == "constant":
        return T.constant(4)
    rng = np.random.default_rng(seed)
    n = 6
    return T(tuple(float(c) for c in rng.uniform(0.2, 2.0, n)),
             tuple(math.inf if rng.random() < 0.3 else float(b)
                   for b in rng.uniform(1e6, 1e9, n)),
             tuple(float(x) for x in rng.uniform(0.0, 0.05, n)),
             _episodes(pkg, rng, n))


def _raises_like_jax(fn_t, fn_j):
    with pytest.raises((ValueError, TypeError)) as ej:
        fn_j()
    with pytest.raises(type(ej.value)) as et:
        fn_t()
    assert str(et.value) == str(ej.value)


TRACES = [("lognormal", 3), ("two_speed", 0), ("constant", 0),
          ("episodes", 1), ("episodes", 7), ("episodes", 11)]


def test_trace_matches_jax(tmp_path):
    for case, seed in TRACES:
        _check_trace(case, seed, tmp_path)


def _check_trace(case, seed, tmp_path):
    tj, tt = _trace(jsim, case, seed), _trace(sim, case, seed)
    assert tt.to_json() == tj.to_json()
    assert tt.ref_step_s == tj.ref_step_s
    assert sim.TraceSet.from_json(tj.to_json()) == tt
    rng = np.random.default_rng(seed + 100)
    for _ in range(200):
        i = int(rng.integers(tt.n))
        start, work = float(rng.uniform(0, 12)), float(rng.uniform(0, 5))
        assert tt.compute_time(i, 3) == tj.compute_time(i, 3)
        assert tt.finish_time(i, start, work) == tj.finish_time(i, start, work)
        j, nbytes = int(rng.integers(tt.n)), int(rng.integers(0, 10**6))
        extra = float(rng.uniform(0, 0.1))
        assert tt.edge_delay(i, j, nbytes, extra) == \
            tj.edge_delay(i, j, nbytes, extra)
    assert sim.barrier_schedule(tt, 6) == jsim.barrier_schedule(tj, 6)
    # JSON through a file, a dict and a path, both ways
    pj = str(tmp_path / f"{case}{seed}_j.json")
    pt = str(tmp_path / f"{case}{seed}_t.json")
    tj.save(pj)
    tt.save(pt)
    assert open(pt).read() == open(pj).read()
    assert sim.TraceSet.load(pj) == tt and jsim.TraceSet.load(pt) == tj
    assert sim.as_trace(pj, tt.n) == sim.as_trace(tt.to_json(), tt.n) == tt
    _raises_like_jax(lambda: sim.as_trace(tt, tt.n + 1),
                     lambda: jsim.as_trace(tj, tj.n + 1))
    _raises_like_jax(lambda: sim.as_trace(3, tt.n),
                     lambda: jsim.as_trace(3, tj.n))
    bad = dict(tj.to_json(), n=tt.n + 2)
    _raises_like_jax(lambda: sim.TraceSet.from_json(bad),
                     lambda: jsim.TraceSet.from_json(bad))


def test_validation_queue_and_schedules_match_jax():
    """Trace and episode validation messages; the queue's pop order under
    permuted insertion, port against JAX; ``barrier_schedule`` and
    ``time_to_loss`` on the reference's cases."""
    for args in [((0.0,), (1.0,), (0.0,)), ((1.0, 1.0), (1.0,), (0.0,)),
                 ((1.0,), (0.0,), (0.0,))]:
        _raises_like_jax(lambda: sim.TraceSet(*args),
                         lambda: jsim.TraceSet(*args))
    for args in [(0, 0.0, 1.0, "pause"), (0, 2.0, 1.0, "preempt"),
                 (0, 0.0, 1.0, "straggle", 0.5)]:
        _raises_like_jax(lambda: sim.Episode(*args),
                         lambda: jsim.Episode(*args))
    _raises_like_jax(
        lambda: sim.TraceSet((1.0,), (math.inf,), (0.0,), episodes=(
            sim.Episode(0, 0.0, 2.0, "preempt"),
            sim.Episode(0, 1.0, 3.0, "preempt"))),
        lambda: jsim.TraceSet((1.0,), (math.inf,), (0.0,), episodes=(
            jsim.Episode(0, 0.0, 2.0, "preempt"),
            jsim.Episode(0, 1.0, 3.0, "preempt"))))

    rng = np.random.default_rng(5)
    specs = []
    for _ in range(60):
        kind = int(rng.integers(3))
        t = float(rng.choice([0.5, 1.0, 1.0, 2.0]))
        a, b, c = (int(x) for x in rng.integers(0, 4, 3))
        specs.append((kind, t, a, b, c))

    def make(ev):
        def one(kind, t, a, b, c):
            if kind == 0:
                return ev.step_event(t, a, b, c)
            if kind == 1:
                return ev.deliver_event(t, a, b, c + 1, ())
            return ev.churn_event(t, b)
        return one

    popped = []
    for pkg, ev in ((sim, events), (jsim, jevents)):
        for perm in (range(60), range(59, -1, -1), rng.permutation(60)):
            q = pkg.EventQueue()
            for k in perm:
                q.push(make(ev)(*specs[int(k)]))
            assert len(q) == 60 and q.peek() is not None
            popped.append([q.pop().key() for _ in range(60)])
            assert not q and q.peek() is None
    assert all(p == popped[0] for p in popped)

    two = (sim.TraceSet.two_speed(4), jsim.TraceSet.two_speed(4))
    assert sim.barrier_schedule(two[0], 3) == \
        jsim.barrier_schedule(two[1], 3) == [4.0, 8.0, 12.0]
    for curve, target in [([(1.0, 5.0), (2.0, 4.0), (3.0, 4.5)], 4.0),
                          ([(1.0, 5.0)], 1.0), ([], 0.0)]:
        assert sim.time_to_loss(curve, target) == \
            jsim.time_to_loss(curve, target)


# the JAX package's tests/test_sim.py::test_trace_config_rejections, case
# for case (``method`` defaults to seedflood)
REJECTIONS = [
    (dict(trace="t.json", method="central_zo"), "trace"),
    (dict(trace="t.json", method="gossip_sr"), "trace"),
    (dict(sim_latency_s=0.5), "set 'trace' as well"),
    (dict(sim_churn_step_s=1.0), "set 'trace' as well"),
    (dict(trace="t.json", checkpoint_every=2, checkpoint_dir="d"),
     "checkpoint"),
    (dict(trace="t.json", flood_k=2), "flood_k"),
    (dict(trace="t.json", epoch_replay=False), "epoch_replay"),
    (dict(trace="t.json", flood_backend="numpy"), "round-synchronous"),
    (dict(trace="t.json", drain=True), "always drain"),
    (dict(trace="t.json", method="dzsgd", churn=(1,)),
     "cannot combine churn"),
    (dict(trace="t.json", method="dzsgd", sim_churn_step_s=1.0),
     "sim_churn_step_s"),
    (dict(trace="t.json", resume_from="ck.npz"), "checkpoint"),
]


def test_trace_config_rejections_match_jax():
    for kw, match in REJECTIONS:
        kw = dict(kw, method=kw.get("method", "seedflood"))
        jkw, tkw = dict(kw), dict(kw)
        if "churn" in kw:
            jkw["churn"] = JChurn.leave_rejoin(kw["churn"], 1, 2)
            tkw["churn"] = ChurnSchedule.leave_rejoin(kw["churn"], 1, 2)
        with pytest.raises(ValueError, match=match) as ej:
            jvalidate(JConfig(**jkw))
        with pytest.raises(ValueError, match=match) as et:
            validate_config(DTrainConfig(**tkw))
        assert str(et.value) == str(ej.value), kw


def _cfg(**kw):
    base = dict(n_clients=4, topology="ring", steps=3, lr=1e-2,
                batch_size=4, subcge_rank=8, local_iters=2,
                arch=sim_arch(**ARCH), task=TaskConfig(**TASK), device="cpu")
    base.update(kw)
    return DTrainConfig(**base)


def _stacked_equal(a, b) -> bool:
    return set(a) == set(b) and all(torch.equal(a[p], b[p]) for p in a)


def test_event_run_equals_sync_run():
    for method in ("seedflood", "dzsgd"):
        _check_oracle(method)


def _check_oracle(method):
    """The port's oracle: with ``TraceSet.constant`` every cohort is the
    whole swarm and the event run is the synchronous run bitwise — curves,
    ledger, final stacked params, gmp, consensus (seedflood under leave /
    rejoin churn at τ = 3, the catch-up crossing an epoch, the sync side
    draining; dzsgd mixing every 2 steps)."""
    if method == "seedflood":
        cfg = _cfg(method=method, steps=6, subcge_tau=3, eval_every=3,
                   drain=True, churn=ChurnSchedule.leave_rejoin([2], 2, 4))
        r_async = run(dataclasses.replace(cfg, drain=False,
                                          trace=sim.TraceSet.constant(4)))
    else:
        cfg = _cfg(method=method, steps=6, eval_every=2)
        r_async = run(dataclasses.replace(cfg, trace=sim.TraceSet.constant(
            4).to_json()))
    r_sync = run(cfg)
    assert r_sync.loss_curve == r_async.loss_curve
    assert r_sync.acc_curve == r_async.acc_curve
    # not consensus_curve: as in the JAX package, the event run reads index
    # T once the swarm reaches step T, after churn at T has landed (a
    # rejoiner counts before its catch-up); the sync run reads it before
    assert r_sync.total_bytes == r_async.total_bytes
    for key in ("n_messages", "sync_bytes", "n_syncs", "valid_loss"):
        assert r_sync.extra.get(key) == r_async.extra.get(key), key
    assert r_sync.gmp == r_async.gmp
    assert r_sync.consensus_error == r_async.consensus_error
    assert _stacked_equal(r_sync.extra["final_stacked"],
                          r_async.extra["final_stacked"])
    assert r_async.extra["virtual_time_s"] == float(cfg.steps)
    assert [vt for vt, _ in r_async.extra["loss_vs_virtual_time"]] == \
        [float(t + 1) for t in range(cfg.steps)]
    assert r_async.extra["step_wall_s"] == []
    if method == "seedflood":
        assert r_async.extra["n_syncs"] > 0
        assert r_async.extra["engine"] == "FloodNetwork"


def test_event_order_independent_of_insertion_order():
    """Queuing the first STEP events in reversed client order changes
    nothing: the queue orders on content, and same-key cascades are
    themselves key-ordered (lognormal trace: one cohort per client)."""
    trace = sim.TraceSet.lognormal(3, sigma=0.6, seed=1)
    cfg = _cfg(method="seedflood", n_clients=3, steps=2, trace=trace,
               flood_backend="python")
    spec = METHOD_SPECS["seedflood"]

    def run_order(order):
        setup = Setup(cfg)
        transport = sim.wrap_async(spec.make_transport(cfg, setup), trace)
        return sim.EventTrainer(cfg, setup, spec.make_method(cfg), transport,
                                trace, init_order=order).run()

    r_fwd = run_order([0, 1, 2])
    r_rev = run_order([2, 1, 0])
    assert r_fwd.loss_curve == r_rev.loss_curve
    assert r_fwd.extra["loss_vs_virtual_time"] == \
        r_rev.extra["loss_vs_virtual_time"]
    assert r_fwd.total_bytes == r_rev.total_bytes
    assert _stacked_equal(r_fwd.extra["final_stacked"],
                          r_rev.extra["final_stacked"])
    assert len(r_fwd.loss_curve) == 3 * cfg.steps
