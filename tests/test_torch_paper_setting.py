"""The paper's evaluation settings in the port, against the JAX package
(host-side numpy and networkx; every case runs in milliseconds):

* every topology of the JAX ``TOPOLOGIES`` at n ∈ {4, 6, 16, 64}: the same
  edges, diameter and neighbour lists, the same Metropolis mixing matrix to
  the last bit and the same spectral gap; ``erdos_renyi`` the same graph;
* both flood engines behind ``FloodTransport``, with full and delayed
  flooding and a drain: the padded payloads equal the JAX engine's of the
  same backend element for element (order included, since it fixes the
  replay's summation order), and the ledgers are equal; ``"auto"`` picks
  the bitset engine from 64 clients on;
* the ``markov`` task's splits bitwise, the ``dirichlet`` partition's index
  sets, and ``accuracy``'s markov branch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import flood as jflood  # noqa: E402
from repro.core.messages import Message as JMessage  # noqa: E402
from repro.core.transport import FloodTransport as JFloodTransport  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.configs import archs as jarchs  # noqa: E402
from repro.topology import graphs as jgraphs  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.core import flood  # noqa: E402
from repro_torch.core.messages import Message  # noqa: E402
from repro_torch.core.transport import FloodTransport  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.topology import graphs  # noqa: E402

from _torch_parity import weights  # noqa: E402

# what the JAX FloodTransport charges the 8 x 8 mesh-grid (chip_smoke.py
# asserts it for its OPT-125M run): (steps, flood_k, drain) -> (msgs, bytes)
MESHGRID64_LEDGER = {(3, None, False): (43000, 344000)}


@pytest.mark.parametrize("n", [4, 6, 16, 64])
@pytest.mark.parametrize("name", sorted(jgraphs.TOPOLOGIES))
def test_topology_matches_jax(name, n):
    gj, gt = jgraphs.make(name, n), graphs.make(name, n)
    assert sorted(gt.nodes) == sorted(gj.nodes) == list(range(n))
    assert {frozenset(e) for e in gt.edges} == {frozenset(e) for e in gj.edges}
    assert graphs.diameter(gt) == jgraphs.diameter(gj)
    assert graphs.neighbors(gt) == jgraphs.neighbors(gj)
    wj, wt = jgraphs.metropolis_weights(gj), graphs.metropolis_weights(gt)
    assert wt.dtype == wj.dtype and (wt == wj).all()
    assert graphs.spectral_gap(wt) == jgraphs.spectral_gap(wj)


def test_topology_names_match_jax():
    assert sorted(graphs.TOPOLOGIES) == sorted(jgraphs.TOPOLOGIES)
    assert graphs.diameter(graphs.make("meshgrid", 64)) == 14
    with pytest.raises(KeyError, match="unknown topology"):
        graphs.make("hypercube", 8)


@pytest.mark.parametrize("seed", [0, 5])
def test_erdos_renyi_matches_jax(seed):
    gj, gt = jgraphs.erdos_renyi(16, 0.3, seed), graphs.erdos_renyi(16, 0.3, seed)
    assert {frozenset(e) for e in gt.edges} == {frozenset(e) for e in gj.edges}


def _msgs(n, t, rng):
    """One step's fresh message per client: distinct seeds, random coefs."""
    seeds = rng.integers(0, 2**32, n, dtype=np.uint32)
    coefs = rng.standard_normal(n).astype(np.float32)
    return [(i, dict(seed=int(seeds[i]), coef=float(coefs[i]), origin=i,
                     step=t)) for i in range(n)]


def _same(ij, it):
    for a in ("seeds", "coefs", "steps"):
        want, got = getattr(ij, a), getattr(it, a)
        assert got.dtype == want.dtype and got.shape == want.shape, a
        assert (got == want).all(), a


@pytest.mark.parametrize("k", [None, 1, 3], ids=["full", "k1", "k3"])
@pytest.mark.parametrize("backend", ["python", "numpy"])
@pytest.mark.parametrize("topo,n", [("meshgrid", 64), ("ring", 64),
                                    ("meshgrid", 16)])
def test_flood_payloads_match_jax(topo, n, backend, k):
    """Three steps of injections, then a drain: every padded payload and
    the ledger equal the JAX engine's of the same backend."""
    steps = 3
    tj = JFloodTransport(jgraphs.make(topo, n), backend=backend, flood_k=k)
    tt = FloodTransport(graphs.make(topo, n), backend=backend, flood_k=k)
    assert type(tt.net).__name__ == type(tj.net).__name__
    assert tt.stats()["engine"] == type(tj.net).__name__
    rng = np.random.default_rng(n + (k or 0))
    for t in range(steps):
        msgs = _msgs(n, t, rng)
        _same(tj.exchange([(i, JMessage(**m)) for i, m in msgs], t,
                          np.ones(n, bool)),
              tt.exchange([(i, Message(**m)) for i, m in msgs], t))
    ledger = (tt.ledger.n_messages, tt.ledger.total_bytes)
    assert ledger == (tj.ledger.n_messages, tj.ledger.total_bytes)
    if (topo, n) == ("meshgrid", 64) and (steps, k, False) in MESHGRID64_LEDGER:
        assert ledger == MESHGRID64_LEDGER[(steps, k, False)]
    for ij, it in zip(tj.drain(steps + 1, steps), tt.drain(steps + 1, steps),
                      strict=True):
        _same(ij, it)
    assert tt.net.in_flight() == tj.net.in_flight() == 0
    assert (tt.ledger.n_messages, tt.ledger.total_bytes) == \
        (tj.ledger.n_messages, tj.ledger.total_bytes)


def test_engines_deliver_the_same_sets_in_other_orders():
    """The two engines agree on what each client receives and on the
    ledger; they order it differently, which is why the port keeps both."""
    g = graphs.make("meshgrid", 64)
    nets = {b: flood.make_network(g, b) for b in flood.FLOOD_BACKENDS}
    rng = np.random.default_rng(0)
    for i, m in _msgs(64, 0, rng):
        for net in nets.values():
            net.inject(i, Message(**m))
    got = {b: net.rounds_arrays(net.diameter) for b, net in nets.items()}
    orders_differ = False
    for a, b in zip(got["python"], got["numpy"]):
        assert sorted(a[0]) == sorted(b[0])
        orders_differ |= not (a[0] == b[0]).all()
    assert orders_differ
    assert nets["python"].ledger == nets["numpy"].ledger
    full = nets["numpy"].full_flood()
    assert nets["numpy"].in_flight() == 0 and len(full) == 64


@pytest.mark.parametrize("n,want", [(63, "FloodNetwork"),
                                    (64, "VectorFloodNetwork")])
def test_auto_backend_switches_at_64(n, want):
    assert flood.AUTO_VECTOR_MIN_CLIENTS == jflood.AUTO_VECTOR_MIN_CLIENTS
    assert type(flood.make_network(graphs.ring(n), "auto")).__name__ == want
    assert type(jflood.make_network(jgraphs.ring(n), "auto")).__name__ == want
    with pytest.raises(KeyError, match="unknown flood backend"):
        flood.make_network(graphs.ring(n), "bitset")


def test_popcount_counts_like_numpy():
    bits = np.random.default_rng(1).integers(0, 256, (5, 40), dtype=np.uint8)
    assert (flood.popcount_rows(bits)
            == np.unpackbits(bits, axis=1).sum(axis=1)).all()


def test_markov_splits_are_bitwise():
    tj, tt = jsyn.TaskConfig(kind="markov"), tsyn.TaskConfig(kind="markov")
    for a, b in zip(jsyn.make_splits(tj), tsyn.make_splits(tt), strict=True):
        assert a.tokens.dtype == b.tokens.dtype
        assert (a.tokens == b.tokens).all() and (a.labels == b.labels).all()
    with pytest.raises(ValueError, match="unknown task"):
        tsyn.make_splits(tsyn.TaskConfig(kind="copy"))


@pytest.mark.parametrize("kind", ["classify", "markov"])
@pytest.mark.parametrize("n", [4, 16, 64])
def test_dirichlet_partition_matches_jax(n, kind):
    dj = jsyn.make_splits(jsyn.TaskConfig(kind=kind, n_valid=8, n_test=8))[0]
    dt = tsyn.make_splits(tsyn.TaskConfig(kind=kind, n_valid=8, n_test=8))[0]
    pj = jsyn.partition(dj, n, scheme="dirichlet", seed=2)
    pt = tsyn.partition(dt, n, scheme="dirichlet", seed=2)
    assert len(pt) == n
    assert all(a.shape == b.shape and (a == b).all() for a, b in zip(pj, pt))
    assert sorted(np.concatenate(pt)) == list(range(len(dt)))
    with pytest.raises(ValueError, match="unknown partition"):
        tsyn.partition(dt, n, scheme="zipf")


def test_markov_accuracy_matches_jax():
    """``accuracy``'s markov branch (next-token argmax over the whole
    vocabulary) on the same weights: the same count of hits."""
    arch_j = jarchs.reduced(jarchs.get("opt-125m"), d_model=32)
    arch_t = tarchs.reduced(tarchs.get("opt-125m"), d_model=32)
    trees, stacked = weights(arch_j, 1, seed=3)
    task = dict(kind="markov", n_train=8, n_valid=8, n_test=48)
    ds_j = jsyn.make_splits(jsyn.TaskConfig(**task))[2]
    ds_t = tsyn.make_splits(tsyn.TaskConfig(**task))[2]
    want = jsyn.accuracy(arch_j, trees[0], ds_j,
                         forward_fn=jax.jit(jtf.forward, static_argnums=0),
                         batch_size=48)
    got = tsyn.accuracy(arch_t, {p: t[0] for p, t in stacked.items()}, ds_t,
                        forward_fn=ttf.forward, batch_size=48)
    assert got == want
