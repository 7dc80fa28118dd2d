"""Network topologies (paper §2.1, §4.1): the port's copy of the part of
``repro/topology/graphs.py`` the flood needs.  Graphs are ``networkx``
undirected graphs over client ids 0..n-1."""
from __future__ import annotations

import networkx as nx


def ring(n: int) -> nx.Graph:
    return nx.cycle_graph(n)


TOPOLOGIES = {"ring": ring}


def make(name: str, n: int) -> nx.Graph:
    if name not in TOPOLOGIES:
        raise KeyError(f"unknown topology '{name}' (have {sorted(TOPOLOGIES)})")
    return TOPOLOGIES[name](n)


def diameter(g: nx.Graph) -> int:
    return nx.diameter(g)


def neighbors(g: nx.Graph) -> list[list[int]]:
    return [sorted(g.neighbors(i)) for i in range(g.number_of_nodes())]
