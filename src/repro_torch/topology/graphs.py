"""Network topologies (paper §2.1, §4.1): the port's copy of
``repro/topology/graphs.py``.

Graphs are ``networkx`` undirected graphs over client ids 0..n-1: the
paper's two evaluation topologies (ring, mesh-grid) and the usual others,
with what the algorithms need of them: diameter, neighbour lists, and the
gossip mixing matrix and its spectral gap.
"""
from __future__ import annotations

import math

import networkx as nx
import numpy as np


def ring(n: int) -> nx.Graph:
    return nx.cycle_graph(n)


def _grid_shape(n: int) -> tuple[int, int]:
    """The most-square factorization rows x cols = n (rows <= cols)."""
    rows = int(math.isqrt(n))
    while n % rows != 0:
        rows -= 1
    return rows, n // rows


def meshgrid(n: int) -> nx.Graph:
    """2D grid with ~square aspect (the paper's 'mesh-grid'); n need not be
    a perfect square.  Nodes are relabelled in sorted (row, col) order."""
    rows, cols = _grid_shape(n)
    g = nx.grid_2d_graph(rows, cols)
    return nx.convert_node_labels_to_integers(g, ordering="sorted")


def torus(n: int) -> nx.Graph:
    rows, cols = _grid_shape(n)
    g = nx.grid_2d_graph(rows, cols, periodic=(rows > 2 and cols > 2))
    return nx.convert_node_labels_to_integers(g, ordering="sorted")


def star(n: int) -> nx.Graph:
    return nx.star_graph(n - 1)


def complete(n: int) -> nx.Graph:
    return nx.complete_graph(n)


def erdos_renyi(n: int, p: float, seed: int = 0) -> nx.Graph:
    """Connected G(n, p): resample until connected (p should be above the
    connectivity threshold ln(n)/n)."""
    rng = np.random.default_rng(seed)
    for _ in range(512):
        g = nx.erdos_renyi_graph(n, p, seed=int(rng.integers(2**31)))
        if nx.is_connected(g):
            return g
    raise ValueError(f"could not sample a connected G({n},{p})")


TOPOLOGIES = {
    "ring": ring,
    "meshgrid": meshgrid,
    "torus": torus,
    "star": star,
    "complete": complete,
}


def make(name: str, n: int) -> nx.Graph:
    if name not in TOPOLOGIES:
        raise KeyError(f"unknown topology '{name}' (have {sorted(TOPOLOGIES)})")
    return TOPOLOGIES[name](n)


def diameter(g: nx.Graph) -> int:
    return nx.diameter(g)


def neighbors(g: nx.Graph) -> list[list[int]]:
    return [sorted(g.neighbors(i)) for i in range(g.number_of_nodes())]


def metropolis_weights(g: nx.Graph) -> np.ndarray:
    """Metropolis–Hastings mixing matrix: symmetric, doubly stochastic,
    w_ij = 1/(1+max(deg_i,deg_j)) on edges — the standard gossip W."""
    n = g.number_of_nodes()
    W = np.zeros((n, n))
    deg = dict(g.degree())
    for i, j in g.edges():
        w = 1.0 / (1.0 + max(deg[i], deg[j]))
        W[i, j] = W[j, i] = w
    for i in range(n):
        W[i, i] = 1.0 - W[i].sum()
    return W


def spectral_gap(W: np.ndarray) -> float:
    """1 - λ2: gossip consensus speed (0 for disconnected)."""
    eig = np.sort(np.abs(np.linalg.eigvalsh(W)))
    return float(1.0 - eig[-2])
