"""The port's event engine against the JAX package's: whole runs, the
async adapters, the float cohort weights, and the constants of
``chip_smoke.py``'s async phase.

* Runs (the d32 one-layer decoder): seedflood under
  ``two_speed(6, bandwidth_bps=1e9, latency_s=0.01)`` with a leave and a
  rejoin, and dzsgd under the same trace with ``sim_latency_s``, against
  the JAX ``EventTrainer``: ledger, ``virtual_time_s``, cohort count and
  the times of ``loss_vs_virtual_time`` exact; losses and final params
  within the port's run tolerance (``assert_run_matches``: loss rtol
  1e-4, params atol 3e-5).  Partial cohorts hand seedflood float weights.
* SeedFlood's float cohort weights: ``n_eff`` is their sum, rows of weight
  0 stay bitwise frozen and send nothing, and 1.0 / 0.0 weights equal the
  boolean mask bit for bit.
* ``wrap_async`` and the adapters refuse what the JAX ones refuse, with
  the same messages.
* ``chip_smoke.py``'s phase-13 constants, derived with no model: stub
  methods drive the JAX and the port's ``EventTrainer`` (and, for (a), the
  synchronous ``Trainer``) over the real flood adapters, each cohort
  sending its seed–scalar messages with coefficient 0; for (c) each
  package's ``AsyncGossipTransport`` wraps a stub that charges one dsgd
  exchange of OPT-125M on a ring of 16.  Ledgers, virtual times, cohort
  times and the replays' K and τ-epochs are the model's, since none of
  them depends on the weights.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")


from repro import sim as jsim  # noqa: E402
from repro.core import messages as jmsg, transport as jtr  # noqa: E402
from repro.data.synthetic import TaskConfig as JTask  # noqa: E402
from repro.dtrain import api as japi  # noqa: E402
from repro.dtrain.api import sim_arch as jsim_arch  # noqa: E402
from repro.dtrain.runner import DTrainConfig as JConfig  # noqa: E402
from repro.dtrain.trainer import Trainer as JTrainer  # noqa: E402
from repro.topology import graphs as jgraphs  # noqa: E402
from repro.topology.dynamic import ChurnSchedule as JChurn  # noqa: E402
from repro_torch import sim  # noqa: E402
from repro_torch.core import messages as tmsg, transport as ttr  # noqa: E402
from repro_torch.data.synthetic import TaskConfig  # noqa: E402
from repro_torch.dtrain import api as tapi  # noqa: E402
from repro_torch.dtrain.api import Setup, sim_arch  # noqa: E402
from repro_torch.dtrain.methods.seedflood import SeedFloodMethod  # noqa: E402
from repro_torch.dtrain.runner import DTrainConfig, run  # noqa: E402
from repro_torch.dtrain.trainer import Trainer  # noqa: E402
from repro_torch.topology import graphs  # noqa: E402
from repro_torch.topology.dynamic import ChurnSchedule  # noqa: E402

from _torch_parity import assert_run_matches, one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = dict(d_model=32, n_layers=1, n_heads=2, d_ff=64)
TASK = dict(vocab=256, n_valid=8, n_test=64)

# chip_smoke.py phase 13 (OPT-125M; the stubs below derive them):
# (a) 16 clients on a ring, seedflood, tau 2, 4 steps, client 3 away for
# steps 1-2, TraceSet.constant: (messages, bytes, sync_bytes, n_syncs)
LEDGER_ASYNC_RING16_CHURN = (1952, 15802, 426, 2)
# (b) 64 clients on the 8 x 8 mesh-grid, seedflood, tau 2, 4 steps under
# two_speed(64, 1.0, 4.0, 1 Gbit/s, 10 ms): (messages, bytes), the virtual
# time, the cohorts' times, and each replay's padded K and tau-epochs
LEDGER_ASYNC_MESHGRID64 = (57344, 458752)
VTIME_ASYNC_MESHGRID64 = 16.300001152000018
COHORTS_ASYNC_MESHGRID64 = (1.0, 2.0, 3.0, 4.0, 4.0, 8.0, 12.0, 16.0)
REPLAYS_ASYNC_MESHGRID64 = ((32, 1), (32, 1), (128, 2), (32, 1), (64, 2),
                            (32, 1), (32, 1), (256, 2))
# (c) dsgd, 16 clients on a ring, local_iters 2, 4 steps, same trace: two
# mixes of DSGD_EXCHANGE_BYTES and the virtual time the mix delay gives
DSGD_EXCHANGE_BYTES = 16_224_681_984
LEDGER_ASYNC_DSGD16 = 2 * DSGD_EXCHANGE_BYTES
VTIME_ASYNC_DSGD16 = 24.132340992
OPT125M_PARAMS = 126_755_328


def _two_speed(pkg, n):
    return pkg.TraceSet.two_speed(n, fast_s=1.0, slow_s=4.0,
                                  bandwidth_bps=1e9, latency_s=0.01)


def _jax_event_run(cfg):
    """The JAX ``run`` of a trace config (its ``_run_event``), with the
    method's ``params_of`` reported as ``extra["final_stacked"]``."""
    from repro.dtrain.methods import METHOD_SPECS
    from repro.dtrain.runner import _churn_schedule, validate_config
    validate_config(cfg)
    spec = METHOD_SPECS[cfg.method]
    trace = jsim.as_trace(cfg.trace, cfg.n_clients)
    if "flood_backend" in spec.consumes:
        cfg = dataclasses.replace(cfg, flood_backend="python")
    setup = japi.Setup(cfg)
    method = spec.make_method(cfg)
    extra = method.result_extra
    method.result_extra = lambda st: {**extra(st),
                                      "final_stacked": method.params_of(st)}
    transport = jsim.wrap_async(spec.make_transport(cfg, setup), trace,
                                cfg.sim_latency_s)
    return jsim.EventTrainer(cfg, setup, method, transport, trace,
                             churn=_churn_schedule(cfg)).run()


# seedflood: client 4 (slow) leaves at step index 1 and rejoins at 2
# (virtual 2.5 s and 5.0 s: the trace's median step is 2.5 s); 3 steps keep
# the JAX replay at two K buckets (each bucket is one compile).  dzsgd: two
# mixes, each a barrier whose delay (with sim_latency_s) the virtual time
# shows.  At 6 clients the port's dzsgd ends 3.04e-5 (4 steps, local_iters
# 2) and 5.11e-5 (3 steps) from JAX's on one element, past the 3e-5
# tolerance, in the synchronous run and, to the bit the same gap, in the
# event run: the ZO coefficient's amplification of float32 loss rounding
# (tests/test_torch_churn_width.py), not the event engine; at 2 steps it
# is 1.43e-5
RUNS = {
    "seedflood": dict(method="seedflood", steps=3, churn=((4,), 1, 2)),
    "dzsgd": dict(method="dzsgd", steps=2, local_iters=1,
                  sim_latency_s=0.005),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_event_run_matches_jax(name):
    kw = dict(RUNS[name])
    churn = kw.pop("churn", None)
    base = dict(n_clients=6, batch_size=2, **kw)
    rj = _jax_event_run(JConfig(
        arch=jsim_arch(**ARCH), task=JTask(**TASK), trace=_two_speed(jsim, 6),
        churn=JChurn.leave_rejoin(*churn) if churn else None, **base))
    rt = run(DTrainConfig(
        arch=sim_arch(**ARCH), task=TaskConfig(**TASK),
        trace=_two_speed(sim, 6),
        churn=ChurnSchedule.leave_rejoin(*churn) if churn else None,
        device="cpu", **base))
    assert_run_matches(rt, rj)
    assert rt.extra["virtual_time_s"] == rj.extra["virtual_time_s"]
    assert len(rt.loss_curve) == len(rj.loss_curve) > kw["steps"]
    assert [vt for vt, _ in rt.extra["loss_vs_virtual_time"]] == \
        [vt for vt, _ in rj.extra["loss_vs_virtual_time"]]
    for k in ("n_messages", "sync_bytes", "n_syncs", "diameter"):
        assert rt.extra.get(k) == rj.extra.get(k), k
    if name == "seedflood":
        assert rt.extra["n_syncs"] > 0
    else:
        assert rt.extra["virtual_time_s"] > 8.0    # two mix delays
    np.testing.assert_allclose(rt.consensus_error, rj.consensus_error,
                               rtol=1e-3, atol=1e-12)


def test_seedflood_takes_float_cohort_weights():
    """The event engine's weights: ``n_eff`` is their sum (3 + 1 = 4
    online clients), rows of weight 0 keep their bits and send nothing,
    and 1.0 / 0.0 weights are the boolean mask bit for bit."""
    cfg = DTrainConfig(arch=sim_arch(**ARCH), task=TaskConfig(**TASK),
                       n_clients=4, batch_size=2, device="cpu")
    setup = Setup(cfg)
    toks = setup.batches(0)

    def step(active):
        m = SeedFloodMethod(cfg)
        st = {p: t.clone() for p, t in m.init(setup).items()}
        return m.local_step(st, toks, active, 0)

    bool_st, bool_out = step(np.array([True, True, False, True]))
    one_st, one_out = step(np.array([1.0, 1.0, 0.0, 1.0]))
    for p, t in bool_st.items():
        assert torch.equal(t, one_st[p]), p
    assert bool_out.payload == one_out.payload
    # a cohort of clients 0 and 1 in a swarm of 4 online: the same n_eff
    # and, on the cohort's rows, the same step as every client online
    all_st, all_out = step(np.ones(4, bool))
    w_st, w_out = step(np.array([3.0, 1.0, 0.0, 0.0]))
    assert [i for i, _ in w_out.payload] == [0, 1]
    assert w_out.payload == all_out.payload[:2]
    for p, t in setup.stacked.items():
        assert torch.equal(w_st[p][:2], all_st[p][:2]), p
        assert torch.equal(w_st[p][2:], t[2:]), p


def test_adapters_refuse_like_jax():
    def both(fn_t, fn_j):
        with pytest.raises(ValueError) as ej:
            fn_j()
        with pytest.raises(ValueError) as et:
            fn_t()
        assert str(et.value) == str(ej.value)

    tr_t, tr_j = sim.TraceSet.constant(64), jsim.TraceSet.constant(64)
    gt, gj = graphs.make("meshgrid", 64), jgraphs.make("meshgrid", 64)
    both(lambda: sim.wrap_async(ttr.FloodTransport(gt, backend="numpy"), tr_t),
         lambda: jsim.wrap_async(jtr.FloodTransport(gj, backend="numpy"),
                                 tr_j))
    both(lambda: sim.wrap_async(ttr.FloodTransport(gt, backend="python",
                                                   flood_k=2), tr_t),
         lambda: jsim.wrap_async(jtr.FloodTransport(gj, backend="python",
                                                    flood_k=2), tr_j))
    both(lambda: sim.wrap_async(ttr.NullTransport(64), tr_t),
         lambda: jsim.wrap_async(jtr.NullTransport(64), tr_j))
    gossip = sim.wrap_async(ttr.GossipTransport(
        gt, graphs.metropolis_weights(gt), every=2), tr_t)
    assert isinstance(gossip, sim.AsyncGossipTransport) and gossip.every == 2
    both(lambda: sim.EventTrainer(None, None, None, gossip, tr_t,
                                  churn=ChurnSchedule.leave_rejoin((1,), 1, 2)),
         lambda: jsim.EventTrainer(None, None, None, jsim.wrap_async(
             jtr.GossipTransport(gj, jgraphs.metropolis_weights(gj), every=2),
             tr_j), tr_j, churn=JChurn.leave_rejoin((1,), 1, 2)))


# -- phase 13's constants, with stub methods ----------------------------------

class _Cfg:
    """The fields the loops read."""

    def __init__(self, **kw):
        self.__dict__.update({"eval_every": 0, "sim_churn_step_s": None,
                              "drain": False, "checkpoint_every": 0,
                              "resume_from": "", **kw})


def _stubs(api, Message, zeros, device):
    """Setup, flood method, gossip method and inner gossip transport stubs
    for one package (``api`` its dtrain.api, ``zeros`` its array maker)."""

    class StubSetup:
        n_params = 0

        def __init__(self):
            self.device = device

        def batches(self, t):
            return None

        def gmp(self, stacked):
            return 0.0

        def valid_loss(self, stacked):
            return 0.0

    class FloodStub(api.MethodBase):
        """Sends each cohort member's seed–scalar message with coefficient
        0; records each replay's padded K and τ-epochs (τ = 2)."""

        def __init__(self, n):
            self.n, self.replays = n, []

        def init(self, setup):
            return {"w": zeros(self.n)}

        def params_of(self, state):
            return state

        def local_step(self, state, batch, active, t):
            out = [(i, Message(seed=1000 * t + i, coef=0.0, origin=i, step=t))
                   for i in range(self.n) if active[i]]
            return state, api.Outbox(losses=np.zeros(self.n, np.float32),
                                     payload=out)

        def apply_inbox(self, state, inbox):
            if inbox is not None and inbox.seeds.shape[1]:
                live = inbox.steps[inbox.steps >= 0]
                self.replays.append((int(inbox.seeds.shape[1]),
                                     len(set((live // 2).tolist()))))
            return state

    class GossipStub(FloodStub):
        def local_step(self, state, batch, active, t):
            return state, api.Outbox(losses=np.zeros(self.n, np.float32),
                                     payload=state)

        def apply_inbox(self, state, inbox):
            return state if inbox is None else inbox

    return StubSetup, FloodStub, GossipStub


def _inner_gossip(ledger_cls, n, every, nbytes):
    """A gossip transport on a ring of n whose exchange charges ``nbytes``
    to a real ledger (one dsgd exchange of OPT-125M)."""

    class InnerGossip:
        live_edges = n

        def __init__(self):
            self.n, self.every = n, every
            self.ledger = ledger_cls(n_edges=n)

        def bind(self, payload):
            pass

        def active_mask(self):
            return np.ones(n, bool)

        def stats(self):
            return {}

        def exchange(self, payload, t, active):
            self.ledger.send(nbytes)
            return payload

    return InnerGossip()


PKGS = {
    "jax": dict(sim=jsim, api=japi, msg=jmsg, tr=jtr, graphs=jgraphs,
                churn=JChurn, trainer=JTrainer,
                zeros=lambda n: np.zeros((n, 1), np.float32), device=None),
    "port": dict(sim=sim, api=tapi, msg=tmsg, tr=ttr, graphs=graphs,
                 churn=ChurnSchedule, trainer=Trainer,
                 zeros=lambda n: torch.zeros(n, 1),
                 device=torch.device("cpu")),
}


def _phase13(pkg: dict, part: str) -> dict:
    p = pkg
    StubSetup, FloodStub, GossipStub = _stubs(p["api"], p["msg"].Message,
                                              p["zeros"], p["device"])
    if part == "c":
        n = 16
        trace = _two_speed(p["sim"], n)
        t = p["sim"].AsyncGossipTransport(_inner_gossip(
            p["msg"].CommLedger, n, 2, DSGD_EXCHANGE_BYTES), trace)
        r = p["sim"].EventTrainer(_Cfg(n_clients=n, steps=4), StubSetup(),
                                  GossipStub(n), t, trace).run()
        return {"bytes": r.total_bytes, "vtime": r.extra["virtual_time_s"],
                "cohorts": [vt for vt, _ in r.extra["loss_vs_virtual_time"]]}
    n, topo = (16, "ring") if part == "a" else (64, "meshgrid")
    trace = p["sim"].TraceSet.constant(n) if part == "a" else \
        _two_speed(p["sim"], n)
    churn = p["churn"].leave_rejoin([3], 1, 3) if part == "a" else None

    def flood():
        return p["tr"].FloodTransport(p["graphs"].make(topo, n),
                                      backend="python")

    method = FloodStub(n)
    r = p["sim"].EventTrainer(_Cfg(n_clients=n, steps=4), StubSetup(), method,
                              p["sim"].wrap_async(flood(), trace), trace,
                              churn=churn).run()
    out = {"ledger": (r.extra["n_messages"], r.total_bytes,
                      r.extra["sync_bytes"], r.extra["n_syncs"]),
           "vtime": r.extra["virtual_time_s"],
           "cohorts": [vt for vt, _ in r.extra["loss_vs_virtual_time"]],
           "replays": method.replays}
    if part == "a":
        rs = p["trainer"](_Cfg(n_clients=n, steps=4, drain=True), StubSetup(),
                          FloodStub(n), flood(), churn=churn).run()
        out["sync_ledger"] = (rs.extra["n_messages"], rs.total_bytes,
                              rs.extra["sync_bytes"], rs.extra["n_syncs"])
    return out


def test_phase13_constants():
    for part in ("a", "b", "c"):
        _check_phase13(part)


def _check_phase13(part):
    got = {name: _phase13(pkg, part) for name, pkg in PKGS.items()}
    assert got["port"] == got["jax"], part
    want = got["jax"]
    if part == "a":
        assert want["ledger"] == want["sync_ledger"] == \
            LEDGER_ASYNC_RING16_CHURN
        assert want["vtime"] == 4.0
    elif part == "b":
        assert want["ledger"] == LEDGER_ASYNC_MESHGRID64 + (0, 0)
        assert want["vtime"] == VTIME_ASYNC_MESHGRID64
        assert tuple(want["cohorts"]) == COHORTS_ASYNC_MESHGRID64
        # the slow half's first cohort replays the fast half's steps 0-2
        # across the tau = 2 boundary (E = 2)
        assert tuple(want["replays"]) == REPLAYS_ASYNC_MESHGRID64
    else:
        assert DSGD_EXCHANGE_BYTES == 2 * 16 * tmsg.dense_payload_bytes(
            OPT125M_PARAMS)
        assert want["bytes"] == LEDGER_ASYNC_DSGD16
        mix = 2 * 0.01 + DSGD_EXCHANGE_BYTES / 16 * 8.0 / 1e9
        assert want["vtime"] == VTIME_ASYNC_DSGD16 == 8.0 + mix + 8.0
        assert want["cohorts"] == [1.0, 2.0, 4.0, 8.0, 8.0 + mix + 1.0,
                                   8.0 + mix + 2.0, 8.0 + mix + 4.0,
                                   8.0 + mix + 8.0]
