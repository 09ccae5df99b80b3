"""Communication topologies (port of ``repro/core/topology.py``).

Host-side numpy metadata, as in the reference.  The GPU machine has no
networkx, so everything the reference asks networkx for is re-implemented
here in plain Python and gives networkx 3.6.1's result:

* :func:`barabasi_albert` — ``networkx.barabasi_albert_graph``: a
  ``star_graph(m)`` start, the ``repeated_nodes`` preferential-attachment
  list, and ``_random_subset`` drawing with ``random.Random(seed).choice``
  into a ``set`` that is then extended in set-iteration order;
* :func:`watts_strogatz` — ``networkx.connected_watts_strogatz_graph``:
  one ``random.Random(seed)`` shared by up to 100 tries, each a ring
  lattice rewired by neighbour distance and then by node, until the graph
  is connected;
* :func:`stochastic_block` — ``networkx.stochastic_block_model`` (sparse
  form: each diagonal block walked densely and then once more by the
  geometric-skip loop, which draws once on the spent iterator; blocks off
  the diagonal by skips only) plus the reference's ``_ensure_connected``;
* the :class:`Topology` centralities — Brandes betweenness, closeness
  (Wasserman–Faust), PageRank (the scipy power iteration with its stop
  rule), eigenvector (the principal eigenvector of the symmetric
  adjacency; :class:`AmbiguousSolution` on a disconnected graph, as
  networkx raises) — and :meth:`Topology.modularity` (Clauset–Newman–Moore
  greedy merging, then the partition's modularity).
"""
from __future__ import annotations

import dataclasses
import math
import random
from collections import deque
from itertools import combinations, islice, product
from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "AmbiguousSolution",
    "Topology",
    "padded_neighbor_tables",
    "coo_edge_list",
    "barabasi_albert",
    "watts_strogatz",
    "stochastic_block",
    "ring",
    "star",
    "fully_connected",
    "from_adjacency",
    "TOPOLOGY_BUILDERS",
    "build_topology",
    "paper_topology_suite",
]


class AmbiguousSolution(ValueError):
    """A centrality with no unique answer on this graph (eigenvector
    centrality of a disconnected graph, where networkx raises its own
    ``AmbiguousSolution``)."""


class PowerIterationFailedConvergence(RuntimeError):
    """PageRank's power iteration did not meet its tolerance in
    ``max_iter`` steps (networkx raises its exception of this name)."""


@dataclasses.dataclass(frozen=True)
class Topology:
    """An undirected communication graph: ``(n, n)`` symmetric 0/1
    float64 adjacency with zero diagonal.  The graph is frozen, so its
    centralities and edge tables are computed once and cached."""

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
        object.__setattr__(self, "_metric_cache", {})

    def _cached(self, key, fn):
        cache = self._metric_cache
        if key not in cache:
            cache[key] = fn()
        return cache[key]

    @property
    def n_nodes(self) -> int:
        return self.adjacency.shape[0]

    @property
    def n_edges(self) -> int:
        return int(self.adjacency.sum()) // 2

    def neighbors(self, i: int) -> np.ndarray:
        """Indices of i's neighbours (excluding i itself)."""
        return np.nonzero(self.adjacency[i])[0]

    def neighborhood(self, i: int) -> np.ndarray:
        """The paper's N_i = neighbours(i) ∪ {i}, sorted."""
        return np.sort(np.concatenate([self.neighbors(i), [i]]))

    def _adj_lists(self) -> List[List[int]]:
        """Each node's neighbours, ascending: the order networkx's
        ``from_numpy_array`` graph lists them in."""
        return self._cached("adj_lists", lambda: [
            [int(j) for j in np.nonzero(row)[0]] for row in self.adjacency])

    def is_connected(self) -> bool:
        return len(_components(self._adj_lists())) == 1

    def degree(self) -> np.ndarray:
        """Degree of each node (number of edges)."""
        return self.adjacency.sum(axis=1)

    # ------------------------------------------------------------------
    # centralities (networkx 3.6.1's values, without networkx)
    # ------------------------------------------------------------------
    def betweenness(self) -> np.ndarray:
        """Betweenness centrality by Brandes' algorithm, normalized as
        ``networkx.betweenness_centrality(G, normalized=True)`` for an
        undirected graph: every ordered pair counted, then scaled by
        1 / ((n - 1)(n - 2))."""
        return self._cached("betweenness", lambda: _betweenness(
            self._adj_lists()))

    def eigenvector(self) -> np.ndarray:
        """Eigenvector centrality as ``networkx.eigenvector_centrality_
        numpy``: the principal eigenvector of the adjacency, signed so
        its sum is positive, unit 2-norm.  Raises
        :class:`AmbiguousSolution` on a disconnected graph, as networkx
        does."""
        def compute():
            if not self.is_connected():
                raise AmbiguousSolution(
                    "eigenvector centrality is not unique on a disconnected "
                    "graph (networkx raises AmbiguousSolution here too)")
            _, vecs = np.linalg.eigh(self.adjacency)
            top = vecs[:, -1]
            return top / (np.sign(top.sum()) * np.linalg.norm(top))
        return self._cached("eigenvector", compute)

    def pagerank(self) -> np.ndarray:
        """PageRank mass as ``networkx.pagerank`` (α = 0.85; its scipy
        power iteration: uniform start and teleport, dangling nodes' mass
        spread uniformly, stop once Σ|x − x_last| < n·1e-6, at most 100
        steps), with its order of operations so the stopping step is the
        same."""
        return self._cached("pagerank", lambda: _pagerank(self.adjacency))

    def closeness(self) -> np.ndarray:
        """Closeness centrality by BFS hop counts, Wasserman–Faust
        component scaling (networkx's default): ``((r−1)/Σd)·((r−1)/
        (n−1))`` with r the size of the node's component."""
        def compute():
            adj = self._adj_lists()
            n = len(adj)
            out = np.zeros(n)
            for s in range(n):
                dist = _bfs_lengths(adj, s)
                tot = sum(dist.values())
                if tot > 0 and n > 1:
                    out[s] = ((len(dist) - 1.0) / tot) * (
                        (len(dist) - 1.0) / (n - 1))
            return out
        return self._cached("closeness", compute)

    def modularity(self) -> float:
        """Modularity of the greedy Clauset–Newman–Moore communities, as
        ``networkx.community.modularity(G, greedy_modularity_
        communities(G))``."""
        return self._cached("modularity", lambda: _modularity(
            self._adj_lists(), self.communities()))

    def communities(self) -> List[frozenset]:
        """``networkx.community.greedy_modularity_communities(G)``: the
        communities, largest first."""
        return self._cached("communities",
                            lambda: _greedy_communities(self._adj_lists()))

    # ------------------------------------------------------------------
    # edge-list views
    # ------------------------------------------------------------------
    def neighbor_tables(self, include_self: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Padded-ELL ``(nbr_idx, nbr_mask)`` over this graph's support;
        ``include_self`` adds the diagonal (the mixing-matrix support)."""
        def compute():
            support = self.adjacency
            if include_self:
                support = support + np.eye(self.n_nodes)
            return padded_neighbor_tables(support)
        return self._cached(("neighbor_tables", bool(include_self)), compute)

    def edge_list(self) -> Tuple[np.ndarray, np.ndarray]:
        """COO directed edge list ``(src, dst)`` (:func:`coo_edge_list`)."""
        return self._cached("edge_list", lambda: coo_edge_list(self.adjacency))

    def max_degree(self) -> int:
        return int(self.degree().max())

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


# ----------------------------------------------------------------------
# graph algorithms over ascending adjacency lists
# ----------------------------------------------------------------------
def _bfs_lengths(adj, s) -> dict:
    dist = {s: 0}
    q = deque([s])
    while q:
        v = q.popleft()
        for w in adj[v]:
            if w not in dist:
                dist[w] = dist[v] + 1
                q.append(w)
    return dist


def _components(adj) -> List[List[int]]:
    """Connected components, each sorted, in the order networkx's
    ``connected_components`` finds them (BFS from the lowest unseen
    node)."""
    seen, comps = set(), []
    for v in range(len(adj)):
        if v not in seen:
            comp = set(_bfs_lengths(adj, v))
            seen |= comp
            comps.append(sorted(comp))
    return comps


def _betweenness(adj) -> np.ndarray:
    """Brandes: a BFS from each source counting shortest paths, then the
    dependencies accumulated in reverse BFS order (networkx's
    ``_single_source_shortest_path_basic`` / ``_accumulate_basic``)."""
    n = len(adj)
    bc = [0.0] * n
    for s in range(n):
        order, preds = [], [[] for _ in range(n)]
        sigma = [0.0] * n
        dist = {s: 0}
        sigma[s] = 1.0
        q = deque([s])
        while q:
            v = q.popleft()
            order.append(v)
            for w in adj[v]:
                if w not in dist:
                    q.append(w)
                    dist[w] = dist[v] + 1
                if dist[w] == dist[v] + 1:
                    sigma[w] += sigma[v]
                    preds[w].append(v)
        delta = dict.fromkeys(order, 0)
        while order:
            w = order.pop()
            coeff = (1 + delta[w]) / sigma[w]
            for v in preds[w]:
                delta[v] += sigma[v] * coeff
            if w != s:
                bc[w] += delta[w]
    if n - 1 >= 2:
        scale = 1 / ((n - 1) * (n - 2))
        bc = [b * scale for b in bc]
    return np.array(bc, dtype=np.float64)


def _pagerank(a: np.ndarray, alpha: float = 0.85, max_iter: int = 100,
              tol: float = 1e-6) -> np.ndarray:
    n = a.shape[0]
    s = a.sum(axis=1)
    s[s != 0] = 1.0 / s[s != 0]
    rows = [(j, np.nonzero(a[j])[0]) for j in range(n)]
    x = np.repeat(1.0 / n, n)
    p = np.repeat(1.0 / n, n)
    dangling = np.where(s == 0)[0]
    for _ in range(max_iter):
        xlast = x
        # x @ (diag(s) A) as scipy's CSC product sums it: row by row
        xa = np.zeros(n)
        for j, cols in rows:
            xa[cols] += x[j] * s[j]
        x = alpha * (xa + sum(x[dangling]) * p) + (1 - alpha) * p
        if np.absolute(x - xlast).sum() < n * tol:
            return x
    raise PowerIterationFailedConvergence(
        f"pagerank did not converge in {max_iter} iterations")


def _greedy_communities(adj) -> List[frozenset]:
    """Clauset–Newman–Moore as ``networkx.community.
    greedy_modularity_communities`` (resolution 1, no cutoff): repeatedly
    merge the pair with the largest modularity gain ΔQ, ties broken by the
    smaller ``(u, v)``; stop before the first negative gain or when one
    row of gains is left.  networkx keeps the gains in heaps keyed
    ``(−ΔQ, (u, v))`` holding each row's best; the global minimum of those
    keys is the minimum over every gain, which is what is taken here."""
    n = len(adj)
    m = sum(len(r) for r in adj) // 2
    if m == 0:
        return [frozenset([v]) for v in range(n)]
    q0 = 1 / m
    a = {v: len(adj[v]) * q0 * 0.5 for v in range(n)}
    dq = {v: {} for v in range(n)}
    for u in range(n):
        for v in adj[u]:
            dq[u][v] = q0 * 1.0 - (a[u] * a[v] + a[u] * a[v])
    communities = {v: frozenset([v]) for v in range(n)}
    while sum(1 for r in dq.values() if r) > 1:
        negdq, u, v = min((-g, r, c) for r, row in dq.items()
                          for c, g in row.items())
        if -negdq < 0:
            break
        communities[v] = frozenset(communities[u] | communities[v])
        del communities[u]
        u_nbrs, v_nbrs = set(dq[u]), set(dq[v])
        both = u_nbrs & v_nbrs
        for w in (u_nbrs | v_nbrs) - {u, v}:
            if w in both:
                g = dq[v][w] + dq[u][w]
            elif w in v_nbrs:
                g = dq[v][w] - (a[u] * a[w] + a[w] * a[u])
            else:
                g = dq[u][w] - (a[v] * a[w] + a[w] * a[v])
            dq[v][w] = dq[w][v] = g
        for w in dq[u]:
            del dq[w][u]
        dq[u] = {}
        a[v] += a[u]
        a[u] = 0
    return sorted(communities.values(), key=len, reverse=True)


def _modularity(adj, communities) -> float:
    """``networkx.community.modularity`` (resolution 1), summed in the
    communities' order."""
    deg_sum = sum(len(r) for r in adj)
    m = deg_sum / 2
    norm = 1 / deg_sum ** 2
    total = 0
    for comm in communities:
        inner = sum(1 for u in comm for v in adj[u] if v in comm and u <= v)
        d = sum(len(adj[u]) for u in comm)
        total = total + (inner / m - 1 * d * d * norm)
    return float(total)


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


def coo_edge_list(adjacency: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """COO directed edge list ``(src, dst)`` int32 for a 0/1 adjacency:
    both orientations of every undirected edge, sorted by (dst, src)."""
    dst, src = np.nonzero(np.asarray(adjacency) > 0)
    return src.astype(np.int32), dst.astype(np.int32)


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
    return len(_components([list(np.nonzero(r)[0]) for r in a])) == 1


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


def _stochastic_block_graph(sizes, probs, rng: random.Random):
    """``networkx.stochastic_block_model(sizes, probs, seed=rng)`` (no
    self-loops, ``sparse=True``): ``(order, edges)``, the node labels in
    the graph's node order and the edges as label pairs, drawn in its
    order.

    The blocks are Python ``set``s of ``range`` slices, built as networkx
    builds them, so they iterate in the same order: not always ascending
    (``set(range(22, 33))`` yields 32 first).  networkx adds the nodes,
    and walks each block's pairs, in that order; its adjacency matrix
    (``to_numpy_array``) lists the nodes in that order too."""
    nodes = range(sum(sizes))
    cum = [sum(sizes[:x]) for x in range(len(sizes) + 1)]
    parts = [set(nodes[cum[x]:cum[x + 1]]) for x in range(len(sizes))]
    order = [v for part in parts for v in part]
    edges = []
    for i in range(len(sizes)):
        for j in range(i, len(sizes)):
            p = probs[i][j]
            if i == j:
                pairs = combinations(parts[i], 2)
                for e in pairs:
                    if rng.random() < p:
                        edges.append(e)
            else:
                pairs = product(parts[i], parts[j])
            # networkx walks the diagonal blocks' spent iterator here too,
            # which costs one more draw
            if p == 1:
                edges.extend(pairs)
            elif p > 0:
                while True:
                    skip = math.floor(math.log(rng.random())
                                      / math.log(1 - p))
                    next(islice(pairs, skip, skip), None)
                    e = next(pairs, None)
                    if e is None:
                        break
                    edges.append(e)
    return order, edges


def stochastic_block(n: int = 33, n_communities: int = 3, p_in: float = 0.5,
                     p_out: float = 0.05, seed: int = 0) -> Topology:
    """SB modular graph: ``n_communities`` blocks of ``n // c`` nodes (the
    first ones one larger), intra-block edge probability ``p_in``,
    inter-block ``p_out`` — the same adjacency as the reference's
    ``stochastic_block``: networkx's generator with ``random.Random(seed)``
    (rows in its node order), then ``_ensure_connected``, which joins each
    component (found from the first unseen row, its labels sorted) to the
    next at labels ``numpy.random.default_rng(seed).choice`` draws.
    Paper: p_in = 0.5, p_out ∈ {0.009, 0.05, 0.9}."""
    sizes = [n // n_communities] * n_communities
    for i in range(n - sum(sizes)):
        sizes[i] += 1
    probs = [[p_in if i == j else p_out for j in range(n_communities)]
             for i in range(n_communities)]
    for row in probs:
        for p in row:
            if p < 0 or p > 1:
                raise ValueError("block probabilities must lie in [0, 1]")
    order, edges = _stochastic_block_graph(sizes, probs, random.Random(seed))
    row_of = {label: k for k, label in enumerate(order)}
    a = np.zeros((n, n))
    for u, v in edges:
        a[row_of[u], row_of[v]] = a[row_of[v], row_of[u]] = 1.0
    comps = [sorted(order[k] for k in c) for c in _components(
        [[int(j) for j in np.nonzero(r)[0]] for r in a])]
    rng = np.random.default_rng(seed)
    for ca, cb in zip(comps[:-1], comps[1:]):
        u = row_of[int(rng.choice(ca))]
        v = row_of[int(rng.choice(cb))]
        a[u, v] = a[v, u] = 1.0
    return Topology(a, name=f"sb_n{n}_c{n_communities}_pout{p_out}",
                    seed=seed)


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


def from_adjacency(adjacency: np.ndarray, name: str = "custom") -> Topology:
    return Topology(np.asarray(adjacency, dtype=np.float64), name=name)


TOPOLOGY_BUILDERS = {
    "ba": barabasi_albert,
    "ws": watts_strogatz,
    "sb": stochastic_block,
    "ring": ring,
    "star": star,
    "full": fully_connected,
}


def build_topology(kind: str, **kwargs) -> Topology:
    """Config entry point: ``build_topology('ba', n=33, p=2, seed=0)``."""
    if kind not in TOPOLOGY_BUILDERS:
        raise KeyError(f"unknown topology kind {kind!r}; have "
                       f"{sorted(TOPOLOGY_BUILDERS)}")
    return TOPOLOGY_BUILDERS[kind](**kwargs)


def paper_topology_suite(seed: int = 0) -> Sequence[Tuple[str, Topology]]:
    """The 12 (per-seed) topology settings of the paper's §5.3."""
    out = []
    for p in (1, 2, 3):
        out.append((f"ba_p{p}", barabasi_albert(33, p, seed)))
    for p_out in (0.009, 0.05, 0.9):
        out.append((f"sb_pout{p_out}", stochastic_block(33, 3, 0.5, p_out,
                                                         seed)))
    for n in (8, 16, 33, 64):
        out.append((f"ba_n{n}", barabasi_albert(n, 2, seed)))
    for n in (8, 16, 33):
        out.append((f"ws_n{n}", watts_strogatz(n, 4, 0.5, seed)))
    return out
