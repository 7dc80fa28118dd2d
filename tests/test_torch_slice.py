"""The port's SeedFlood run against ``repro.dtrain.runner.run``, end to end
on the CPU with full flooding (the delayed-flooding run has its own file),
and the flood ledgers the chip smoke test asserts.

Tolerances (each side draws its own weights and subspaces from the seed;
those Gaussians are bitwise equal, see test_torch_prng, so the gaps below
come from float32 summation order in the two forwards):

* byte ledger and message count: equal (host-side flood, same protocol);
* loss curve: rtol 1e-4;
* final params: allclose at atol 3e-5 — the ZO coefficient is a finite
  difference (L+ − L−) / 2ε, which turns float32 rounding differences of
  the two forwards (~1e-6 relative) into ~1e-3 relative coefficient
  differences, then scales them by U[:, i] V[:, j];
* consensus inside the port: < 1e-10.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.messages import Message as JMessage  # noqa: E402
from repro.core.transport import FloodTransport as JFloodTransport  # noqa: E402
from repro.data.synthetic import TaskConfig as JTask  # noqa: E402
from repro.dtrain.runner import DTrainConfig as JConfig, run as jrun  # noqa: E402
from repro.dtrain.api import sim_arch as jsim_arch  # noqa: E402
from repro.topology import graphs as jgraphs  # noqa: E402
from repro_torch.core.messages import Message  # noqa: E402
from repro_torch.core.transport import FloodTransport  # noqa: E402
from repro_torch.data.synthetic import TaskConfig  # noqa: E402
from repro_torch.dtrain.runner import DTrainConfig, run  # noqa: E402
from repro_torch.dtrain.api import sim_arch  # noqa: E402
from repro_torch.models import params as tplib  # noqa: E402
from repro_torch.topology import graphs  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401

# one torch thread per test: under pytest-xdist the intra-op pools of the
# workers wait on each other (tests/_torch_parity.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64)
# a short test split keeps the final accuracy pass cheap; the training
# split comes first from the task's rng, so it is the default one
TASK = dict(vocab=256, n_valid=8, n_test=64)
RUN = dict(n_clients=4, steps=3, batch_size=2)
# what the JAX FloodTransport charges a ring of 8 (chip_smoke.py asserts
# these for its Qwen1.5-0.5B runs): (steps, flood_k, drain) -> (messages, bytes)
RING8_LEDGER = {(3, None, False): (368, 2944), (6, 1, True): (768, 6144)}
# ... and a ring of 4 with full flooding (its Gemma 3 1B long-sequence arm
# and its Qwen2-72B cut): steps -> (messages, bytes)
RING4_LEDGER = {2: (56, 448), 3: (88, 704)}
# ... and a ring of 3, 3 steps (its Jamba cut)
RING3_LEDGER = (42, 336)


def test_full_flood_run_matches_jax():
    kw = dict(RUN)
    rj = jrun(JConfig(arch=jsim_arch(**ARCH), task=JTask(**TASK), **kw))
    rt = run(DTrainConfig(arch=sim_arch(**ARCH), task=TaskConfig(**TASK),
                          device="cpu", **kw))
    assert rt.total_bytes == rj.total_bytes
    assert rt.bytes_per_edge == rj.bytes_per_edge
    assert rt.extra["n_messages"] == rj.extra["n_messages"]
    np.testing.assert_allclose(rt.loss_curve, rj.loss_curve, rtol=1e-4)
    assert rt.consensus_error < 1e-10
    want = tplib.flatten(jax.tree.map(np.asarray, rj.extra["final_stacked"]))
    got = rt.extra["final_stacked"]
    assert set(got) == set(want)
    for p, w in want.items():
        np.testing.assert_allclose(got[p].numpy(), w, atol=3e-5, err_msg=p)


def test_run_refuses_what_it_cannot_do():
    with pytest.raises(KeyError, match="unknown method"):
        run(DTrainConfig(method="sgd", device="cpu"))
    with pytest.raises(KeyError, match="unknown flood backend"):
        run(DTrainConfig(arch=sim_arch(**ARCH), task=TaskConfig(**TASK),
                         flood_backend="bitset", steps=1, device="cpu",
                         **{k: v for k, v in RUN.items() if k != "steps"}))
    if not torch.cuda.is_available():
        # the default device is the card; without one the run raises rather
        # than falling back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(DTrainConfig(arch=sim_arch(**ARCH), steps=1))


def _ring_ledgers(n, steps, k=None, drain=False):
    """Both packages' FloodTransport over a ring of n, every client sending
    one message per step: (port, JAX) (messages, bytes), inboxes equal."""
    tj = JFloodTransport(jgraphs.make("ring", n), flood_k=k)
    tt = FloodTransport(graphs.make("ring", n), flood_k=k)
    for t in range(steps):
        msgs = [(i, dict(seed=i + 65536 * t, coef=0.1 * i, origin=i, step=t))
                for i in range(n)]
        ij = tj.exchange([(i, JMessage(**m)) for i, m in msgs], t,
                         np.ones(n, bool))
        it = tt.exchange([(i, Message(**m)) for i, m in msgs], t)
        for a in ("seeds", "coefs", "steps"):
            assert (getattr(ij, a) == getattr(it, a)).all()
    if drain:
        for ij, it in zip(tj.drain(steps + 1, steps), tt.drain(steps + 1, steps),
                          strict=True):
            assert (ij.seeds == it.seeds).all() and (ij.steps == it.steps).all()
    return ((tt.ledger.n_messages, tt.ledger.total_bytes),
            (tj.ledger.n_messages, tj.ledger.total_bytes))


@pytest.mark.parametrize("key", sorted(RING8_LEDGER, key=str))
def test_ring8_ledger_matches_jax(key):
    steps, k, drain = key
    assert _ring_ledgers(8, steps, k, drain) == (RING8_LEDGER[key],) * 2


@pytest.mark.parametrize("steps", sorted(RING4_LEDGER))
def test_ring4_ledger_matches_jax(steps):
    assert _ring_ledgers(4, steps) == (RING4_LEDGER[steps],) * 2


def test_ring3_ledger_matches_jax():
    assert _ring_ledgers(3, 3) == (RING3_LEDGER,) * 2
