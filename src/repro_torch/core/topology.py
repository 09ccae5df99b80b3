"""Communication topologies (port of ``repro/core/topology.py``).

Host-side numpy metadata, as in the reference.  The GPU machine has no
networkx, so the random generators re-implement networkx's (3.x) in plain
Python and give the same graph from the same seed:

* :func:`barabasi_albert` — ``networkx.barabasi_albert_graph``: a
  ``star_graph(m)`` start, the ``repeated_nodes`` preferential-attachment
  list, and ``_random_subset`` drawing with ``random.Random(seed).choice``
  into a ``set`` that is then extended in set-iteration order;
* :func:`watts_strogatz` — ``networkx.connected_watts_strogatz_graph``:
  one ``random.Random(seed)`` shared by up to 100 tries, each a ring
  lattice rewired by neighbour distance and then by node, until the graph
  is connected.

Betweenness, eigenvector, pagerank and closeness centralities need
networkx in the reference and wait for a later slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Tuple

import numpy as np

__all__ = [
    "Topology",
    "padded_neighbor_tables",
    "barabasi_albert",
    "watts_strogatz",
    "ring",
    "star",
    "fully_connected",
]


@dataclasses.dataclass(frozen=True)
class Topology:
    """An undirected communication graph: ``(n, n)`` symmetric 0/1
    float64 adjacency with zero diagonal."""

    adjacency: np.ndarray
    name: str = "custom"
    seed: int = -1

    def __post_init__(self):
        a = np.asarray(self.adjacency, dtype=np.float64)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"adjacency must be square, got {a.shape}")
        if not np.allclose(a, a.T):
            raise ValueError("adjacency must be symmetric (undirected graph)")
        if np.any(np.diag(a) != 0):
            raise ValueError("adjacency must have zero diagonal")
        if not np.all((a == 0) | (a == 1)):
            raise ValueError("adjacency must be 0/1")
        object.__setattr__(self, "adjacency", a)

    @property
    def n_nodes(self) -> int:
        return self.adjacency.shape[0]

    @property
    def n_edges(self) -> int:
        return int(self.adjacency.sum()) // 2

    def neighbors(self, i: int) -> np.ndarray:
        """Indices of i's neighbours (excluding i itself)."""
        return np.nonzero(self.adjacency[i])[0]

    def degree(self) -> np.ndarray:
        """Degree of each node (number of edges)."""
        return self.adjacency.sum(axis=1)

    def neighbor_tables(self, include_self: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Padded-ELL ``(nbr_idx, nbr_mask)`` over this graph's support;
        ``include_self`` adds the diagonal (the mixing-matrix support)."""
        support = self.adjacency
        if include_self:
            support = support + np.eye(self.n_nodes)
        return padded_neighbor_tables(support)

    def nodes_by_degree(self) -> np.ndarray:
        """Node indices sorted by degree, descending (ties → lower index)."""
        return np.argsort(-self.degree(), kind="stable")

    def kth_highest_degree_node(self, k: int) -> int:
        """The paper places OOD data on the k-th highest degree node
        (1-based)."""
        order = self.nodes_by_degree()
        if not 1 <= k <= len(order):
            raise ValueError(f"k={k} out of range for n={len(order)}")
        return int(order[k - 1])


def padded_neighbor_tables(
        support: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Padded-ELL neighbour tables for a 0/1 support mask: row ``i`` lists
    the columns with ``support[i, j] > 0`` (sorted), right-padded to the
    widest row ``dmax`` with the row's OWN index under mask 0.  Returns
    ``(nbr_idx int32, nbr_mask float32)``, both ``(n, dmax)``."""
    s = np.asarray(support) > 0
    if s.ndim != 2 or s.shape[0] != s.shape[1]:
        raise ValueError(f"support must be square, got {s.shape}")
    n = s.shape[0]
    dmax = max(int(s.sum(axis=1).max()) if n else 0, 1)
    nbr_idx = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, dmax))
    nbr_mask = np.zeros((n, dmax), dtype=np.float32)
    for i in range(n):
        js = np.nonzero(s[i])[0]
        nbr_idx[i, :len(js)] = js
        nbr_mask[i, :len(js)] = 1.0
    return nbr_idx, nbr_mask


def _random_subset(seq, m: int, rng: random.Random) -> set:
    """m unique elements of ``seq`` — networkx's ``_random_subset``."""
    targets = set()
    while len(targets) < m:
        targets.add(rng.choice(seq))
    return targets


def barabasi_albert(n: int, p: int, seed: int = 0) -> Topology:
    """BA scale-free graph: n nodes, each new node attaches with p edges —
    the same graph ``networkx.barabasi_albert_graph(n, p, seed)`` gives."""
    if p < 1 or p >= n:
        raise ValueError(f"Barabási–Albert needs 1 <= p < n, got p={p}, n={n}")
    rng = random.Random(seed)
    a = np.zeros((n, n))
    # star_graph(p): hub 0 joined to spokes 1..p; G.degree() lists the hub
    # (degree p) first, then each spoke (degree 1)
    a[0, 1:p + 1] = a[1:p + 1, 0] = 1.0
    repeated_nodes = [0] * p + list(range(1, p + 1))
    for source in range(p + 1, n):
        targets = _random_subset(repeated_nodes, p, rng)
        for t in targets:
            a[source, t] = a[t, source] = 1.0
        repeated_nodes.extend(targets)
        repeated_nodes.extend([source] * p)
    return Topology(a, name=f"ba_n{n}_p{p}", seed=seed)


def _ws_graph(n: int, k: int, p: float, rng: random.Random) -> np.ndarray:
    """One ``networkx.watts_strogatz_graph(n, k, p, rng)`` draw as an
    adjacency matrix, drawing from ``rng`` in networkx's order."""
    if k > n:
        raise ValueError(f"k>n, choose smaller k or larger n (k={k}, n={n})")
    if k == n:
        return np.ones((n, n)) - np.eye(n)
    nbrs = [set() for _ in range(n)]
    nodes = list(range(n))
    for j in range(1, k // 2 + 1):
        for u in nodes:
            v = (u + j) % n
            nbrs[u].add(v)
            nbrs[v].add(u)
    # rewire: neighbour distance j outside, nodes in order inside
    for j in range(1, k // 2 + 1):
        for u in nodes:
            v = (u + j) % n
            if rng.random() < p:
                w = rng.choice(nodes)
                # no self-loops or multiple edges
                while w == u or w in nbrs[u]:
                    w = rng.choice(nodes)
                    if len(nbrs[u]) >= n - 1:
                        break   # no free target: skip this edge
                else:
                    nbrs[u].remove(v)
                    nbrs[v].remove(u)
                    nbrs[u].add(w)
                    nbrs[w].add(u)
    a = np.zeros((n, n))
    for u in nodes:
        a[u, sorted(nbrs[u])] = 1.0
    return a


def _is_connected(a: np.ndarray) -> bool:
    n = a.shape[0]
    seen = {0}
    frontier = [0]
    while frontier:
        frontier = [int(v) for u in frontier for v in np.nonzero(a[u])[0]
                    if int(v) not in seen]
        seen.update(frontier)
    return len(seen) == n


def watts_strogatz(n: int, k: int = 4, u: float = 0.5, seed: int = 0,
                   tries: int = 100) -> Topology:
    """WS small-world graph, the connected variant: ring of n nodes, k
    nearest neighbours, rewiring probability u — the same graph
    ``networkx.connected_watts_strogatz_graph(n, k, u, seed=seed)`` gives."""
    rng = random.Random(seed)
    for _ in range(tries):
        a = _ws_graph(n, k, u, rng)
        if _is_connected(a):
            return Topology(a, name=f"ws_n{n}_k{k}_u{u}", seed=seed)
    raise ValueError("Maximum number of tries exceeded")


def ring(n: int) -> Topology:
    """Deterministic ring."""
    a = np.zeros((n, n))
    for i in range(n):
        a[i, (i + 1) % n] = a[(i + 1) % n, i] = 1.0
    return Topology(a, name=f"ring_n{n}")


def star(n: int) -> Topology:
    """Deterministic hub-and-spoke graph (node 0 = hub)."""
    if n < 2:
        raise ValueError(f"star needs n >= 2, got {n}")
    a = np.zeros((n, n))
    a[0, 1:] = a[1:, 0] = 1.0
    return Topology(a, name=f"star_n{n}")


def fully_connected(n: int) -> Topology:
    """Complete graph — the FL baseline's implicit topology."""
    a = np.ones((n, n)) - np.eye(n)
    return Topology(a, name=f"full_n{n}")
