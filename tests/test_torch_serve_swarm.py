"""The port's DecodeServer and ServeSwarmSim against the JAX package's, at
the reduced TinyLlama on the CPU.

* greedy and temperature streams of a continuous-batching server (staggered
  prompt lengths, 4 requests through ``max_batch=2``: admission, eviction,
  page reuse and a second prefill) equal to the JAX ``DecodeServer``'s,
  token for token (the logits agree within 1e-5, test_torch_serve.py);
* the serve swarm under churn (2 trainers and 1 server on a ring of 3,
  the server away for step 1): token streams, ledger and per-server stats
  equal to the JAX ``ServeSwarmSim``'s; and ``chip_smoke.py`` phase serve's
  script (2 trainers and 2 servers on a ring of 4, server 3 away for step
  1) in the port, twice: it replays, with the ledger below;
* ``LEDGER_SERVE_SWARM_4STEPS``, the ledger ``chip_smoke.py`` phase serve
  asserts at TinyLlama's full width, derived from the JAX FloodTransport
  alone on the same script (the ledger does not depend on the model).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import archs as jarchs  # noqa: E402
from repro.core.messages import Message as JMessage  # noqa: E402
from repro.core.seeds import client_seeds as jclient_seeds  # noqa: E402
from repro.core.subcge import SubCGEConfig as JSubCGE  # noqa: E402
from repro.core.transport import FloodTransport as JFlood  # noqa: E402
from repro.serve import DecodeServer as JServer, Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeSwarmSim as JSwarm  # noqa: E402
from repro.topology import graphs as jgraphs  # noqa: E402
from repro.topology.dynamic import ChurnSchedule as JChurn  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.core.subcge import SubCGEConfig  # noqa: E402
from repro_torch.models import params as tplib  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import DecodeServer, LiveUpdateBridge, Request, \
    ServeConfig, ServeSwarmSim  # noqa: E402
from repro_torch.topology.dynamic import ChurnSchedule  # noqa: E402

from _torch_parity import one_thread, weights  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

# what the JAX FloodTransport charges the swarm script below: (messages,
# bytes, sync_bytes, n_syncs); chip_smoke.py phase serve asserts the port's
# full-width swarm against it
LEDGER_SERVE_SWARM_4STEPS = (56, 502, 70, 2)
SWARM = dict(n_trainers=2, n_servers=2, train_steps=4, global_seed=7)
LEAVE = ((3,), 1, 2)                 # server 3 leaves at step 1, rejoins at 2
SCFG = dict(rank=4, refresh_period=2, eps=1e-3)
SERVE = dict(max_batch=2, page_size=4, n_pages=12, max_seq=20)


@pytest.fixture(scope="module")
def archs():
    return (jarchs.reduced(jarchs.get("tinyllama-1.1b")),
            tarchs.reduced(tarchs.get("tinyllama-1.1b")))


@pytest.fixture(scope="module")
def jparams(archs):
    return weights(archs[0], 1)[0][0]


def _requests(vocab, lens, max_new, seed):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, vocab, L).astype(np.int32), n)
            for rid, (L, n) in enumerate(zip(lens, max_new))]


@pytest.mark.parametrize("sampling", ["greedy", "temperature"])
def test_server_streams_match_jax(archs, jparams, sampling):
    arch_j, arch_t = archs
    kw = dict(SERVE, sampling=sampling, temperature=0.8, sample_seed=3)
    reqs = _requests(arch_t.vocab, (6, 9, 6, 9), (5, 3, 4, 5), seed=4)
    jsrv = JServer(arch_j, jparams, JServeConfig(**kw))
    tsrv = DecodeServer(arch_t, tplib.from_numpy(jparams),
                        ServeConfig(**kw), device="cpu")
    for rid, prompt, n in reqs:
        jsrv.submit(JRequest(rid=rid, prompt=prompt, max_new=n))
        tsrv.submit(Request(rid=rid, prompt=prompt, max_new=n))
    want = jsrv.run()
    assert tsrv.run() == want
    assert tsrv.stats() == jsrv.stats()
    assert tsrv.stats()["prefills"] == 4    # 6 and 9, then each in a freed slot


def _swarm_script(vocab):
    return _requests(vocab, (8, 8, 8, 8), (8, 8, 8, 8), seed=1)


def _record_folds(bridge) -> list:
    """Wrap ``bridge`` so that each fold logs the (seeds, coefs, steps)
    arrays its ingest_arrays took in since the fold before."""
    folds, taken = [], []
    ingest, fold = bridge.ingest_arrays, bridge.fold

    def rec_ingest(*arrays):
        taken.append(tuple(np.array(a) for a in arrays))
        return ingest(*arrays)

    def rec_fold(params):
        folds.append(list(taken))
        taken.clear()
        return fold(params)
    bridge.ingest_arrays, bridge.fold = rec_ingest, rec_fold
    return folds


def _port_swarm(arch, swarm, leave, reqs):
    """Run the port's swarm; returns its result, the servers and, for each
    server, the messages of each of its folds."""
    sim = ServeSwarmSim(arch, SubCGEConfig(**SCFG), ServeConfig(**SERVE),
                        churn=ChurnSchedule.leave_rejoin(*leave),
                        device="cpu", **swarm)
    folds = {node: _record_folds(srv.bridge)
             for node, srv in sim.servers.items()}
    for rid, prompt, n in reqs:
        sim.submit(swarm["n_trainers"] + rid * swarm["n_servers"] // len(reqs),
                   Request(rid=rid, prompt=prompt, max_new=n))
    return sim.run(), sim.servers, folds


def test_swarm_under_churn_matches_jax(archs):
    """One server on a ring of 3 (the JAX swarm compiles per server):
    server 2 leaves at step 1 and rejoins at 2."""
    arch_j, arch_t = archs
    swarm, leave = dict(SWARM, n_servers=1), ((2,), 1, 2)
    reqs = _swarm_script(arch_t.vocab)[:2]
    jsim = JSwarm(arch_j, JSubCGE(**SCFG, kernel_backend="jnp"),
                  JServeConfig(**SERVE), churn=JChurn.leave_rejoin(*leave),
                  **swarm)
    for rid, prompt, n in reqs:
        jsim.submit(2, JRequest(rid=rid, prompt=prompt, max_new=n))
    want = jsim.run()
    got = _port_swarm(arch_t, swarm, leave, reqs)[0]
    assert got["tokens"] == want["tokens"]
    assert got["ledger"] == want["ledger"]
    assert got["servers"] == want["servers"]
    # the churn bit: the server was suspended mid-decode and re-prefilled,
    # and caught its weights up through the flood
    assert got["servers"][2]["suspends"] == 2
    assert got["servers"][2]["prefills"] == 2
    assert got["servers"][2]["bridge"]["messages_folded"] > 0


def test_swarm_of_phase_serve_replays_with_its_ledger(archs):
    """chip_smoke.py phase serve's script (2 trainers, 2 servers, server 3
    away for step 1) in the port, twice: the same tokens, ledger and
    stats, and the JAX transport's ledger.  Each server's final weights
    equal, bitwise, the initial weights folded offline over exactly the
    messages of that server's own folds (no server sees another's)."""
    arch_t = archs[1]
    reqs = _swarm_script(arch_t.vocab)
    a, servers, folds = _port_swarm(arch_t, SWARM, LEAVE, reqs)
    b = _port_swarm(arch_t, SWARM, LEAVE, reqs)[0]
    for node, srv in servers.items():
        want = ttf.init_params(arch_t, 0, "cpu")
        offline = LiveUpdateBridge(arch_t, SubCGEConfig(**SCFG),
                                   SWARM["global_seed"], node)
        for taken in folds[node]:
            for arrays in taken:
                offline.ingest_arrays(*arrays)
            offline.fold(want)
        assert len(folds[node]) == srv.bridge.n_folds > 0
        assert all(torch.equal(srv.params[k], t) for k, t in want.items())
    assert a["tokens"] == b["tokens"] and a["ledger"] == b["ledger"]
    assert a["servers"] == b["servers"]
    led = a["ledger"]
    assert (led["n_messages"], led["total_bytes"], led["sync_bytes"],
            led["n_syncs"]) == LEDGER_SERVE_SWARM_4STEPS
    assert a["servers"][3]["suspends"] == 2 and a["servers"][3]["prefills"] == 2
    assert sorted(a["tokens"]) == [0, 1, 2, 3]
    with pytest.raises(ValueError):                 # trainers do not churn
        ServeSwarmSim(arch_t, SubCGEConfig(**SCFG), ServeConfig(**SERVE),
                      churn=ChurnSchedule.leave_rejoin((0,), 1, 2),
                      device="cpu", **SWARM)


def test_swarm_ledger_constant_from_the_jax_transport():
    """The swarm's flood, replayed on the JAX FloodTransport alone: a
    trainer tick at each step t (time t), churn events at step s after the
    tick at the same time (CHURN ranks after STEP)."""
    n = SWARM["n_trainers"] + SWARM["n_servers"]
    tr = JFlood(jgraphs.ring(n))
    sched = JChurn.leave_rejoin(*LEAVE)
    online = np.ones(n, bool)
    for t in range(SWARM["train_steps"]):
        seeds = jclient_seeds(SWARM["global_seed"], t, SWARM["n_trainers"])
        msgs = [(i, JMessage(seed=int(seeds[i]), coef=0.01 / (1 + t + i),
                             origin=i, step=t))
                for i in range(SWARM["n_trainers"])]
        tr.exchange(msgs, t, online.copy())
        evs = sched.events_at(t)
        if evs:
            tr.apply_churn(evs)
            online = tr.active_mask()
    led = tr.ledger
    assert (led.n_messages, led.total_bytes, led.sync_bytes,
            led.n_syncs) == LEDGER_SERVE_SWARM_4STEPS
