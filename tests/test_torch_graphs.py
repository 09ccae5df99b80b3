"""The port's networkx-free graph layer (``repro_torch.core.topology``)
against networkx 3.6.1 and ``repro.core.topology``: Brandes betweenness,
closeness, PageRank, eigenvector centrality, greedy-modularity
communities and their modularity, the stochastic block generator, and the
rest of the module, on the paper's topology suite and on disconnected
link-failure survivors."""
import random

import numpy as np
import pytest

from repro.core import dynamic as jdyn
from repro.core import topology as jtopo
from repro.core.strategies import AggregationStrategy as JStrategy
from repro_torch.core import dynamic as tdyn
from repro_torch.core import topology as ttopo
from repro_torch.core.strategies import AggregationStrategy as TStrategy

nx = pytest.importorskip("networkx")

SUITE = jtopo.paper_topology_suite(0)
SUITE_NAMES = [name for name, _ in SUITE]


def _survivors():
    """BA(16, 2) survivors of 60% link failure; several are disconnected."""
    out = []
    for seed in range(6):
        topo = jtopo.barabasi_albert(16, 2, seed)
        out.append(jdyn.drop_edges(topo, 0.6, np.random.default_rng(seed)))
    return out


SURVIVORS = _survivors()
GRAPHS = [t for _, t in SUITE] + SURVIVORS
GRAPH_IDS = SUITE_NAMES + [f"survivor{i}" for i in range(len(SURVIVORS))]

# measured on these graphs (networkx 3.6.1): betweenness, closeness and
# pagerank 0 (the same operations in the same order); eigenvector 3.2e-15
# (LAPACK eigh against ARPACK); modularity 1.1e-16
TOLS = {"betweenness": 1e-12, "closeness": 1e-12, "pagerank": 1e-12,
        "eigenvector": 1e-10}


def test_survivors_include_disconnected_graphs():
    assert sum(not t.is_connected() for t in SURVIVORS) >= 2


@pytest.mark.parametrize("metric", sorted(TOLS))
@pytest.mark.parametrize("i", range(len(GRAPHS)), ids=GRAPH_IDS)
def test_centrality_matches_networkx(metric, i):
    jt = GRAPHS[i]
    tt = ttopo.from_adjacency(jt.adjacency)
    if metric == "eigenvector" and not jt.is_connected():
        with pytest.raises(nx.AmbiguousSolution):
            jt.eigenvector()
        with pytest.raises(ttopo.AmbiguousSolution):
            tt.eigenvector()
        return
    want = getattr(jt, metric)()
    got = getattr(tt, metric)()
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOLS[metric])
    assert getattr(tt, metric)() is got    # cached on the frozen graph


@pytest.mark.parametrize("i", range(len(GRAPHS)), ids=GRAPH_IDS)
def test_modularity_matches_networkx(i):
    """The same partition as ``greedy_modularity_communities`` (as sets)
    and its modularity to 1e-12 (measured: 1.1e-16)."""
    jt = GRAPHS[i]
    tt = ttopo.from_adjacency(jt.adjacency)
    want = nx.community.greedy_modularity_communities(jt.to_networkx())
    assert set(map(frozenset, want)) == set(tt.communities())
    assert [len(c) for c in tt.communities()] == [len(c) for c in want]
    assert tt.modularity() == pytest.approx(jt.modularity(), abs=1e-12)


def test_pagerank_raises_when_it_does_not_converge():
    jt = SUITE[0][1]
    with pytest.raises(nx.PowerIterationFailedConvergence):
        nx.pagerank(jt.to_networkx(), max_iter=2)
    with pytest.raises(ttopo.PowerIterationFailedConvergence):
        ttopo._pagerank(jt.adjacency, max_iter=2)


def test_reactive_eigenvector_raises_on_a_disconnected_survivor():
    """networkx 3.6.1 refuses eigenvector centrality on a disconnected
    graph, so the reference's reactive host path raises for a round whose
    survivor is disconnected; the port raises there too."""
    jt = jtopo.barabasi_albert(16, 2, 0)
    tt = ttopo.barabasi_albert(16, 2, 0)
    for r in range(20):
        rng = np.random.default_rng((0 * 1_000_003 + r) * 7919 + 17)
        if not jdyn.drop_edges(jt, 0.6, rng).is_connected():
            break
    else:
        pytest.fail("no disconnected survivor in 20 rounds")
    with pytest.raises(nx.AmbiguousSolution):
        jdyn.dynamic_mixing_matrix(jt, JStrategy("eigenvector"), r, 0.6,
                                   reactive=True)
    with pytest.raises(ttopo.AmbiguousSolution):
        tdyn.dynamic_mixing_matrix(tt, TStrategy("eigenvector"), r, 0.6,
                                   reactive=True)


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("n", [16, 33])
@pytest.mark.parametrize("p_out", [0.009, 0.05, 0.9])
def test_stochastic_block_equals_reference(seed, n, p_out):
    want = jtopo.stochastic_block(n, 3, 0.5, p_out, seed)
    got = ttopo.stochastic_block(n, 3, 0.5, p_out, seed)
    assert np.array_equal(got.adjacency, want.adjacency)
    assert got.name == want.name and got.seed == want.seed
    assert got.is_connected()


@pytest.mark.parametrize("seed", range(4))
def test_stochastic_block_joins_components_in_networkx_order(seed):
    """At p_out = 0 the blocks are components joined by
    ``_ensure_connected``; at n = 33 the third block's set iterates 32
    first, so networkx's row order differs from the labels."""
    want = jtopo.stochastic_block(33, 3, 0.5, 0.0, seed)
    got = ttopo.stochastic_block(33, 3, 0.5, 0.0, seed)
    assert np.array_equal(got.adjacency, want.adjacency)


def test_stochastic_block_draw_count():
    """Three 11-node blocks at p_out = 0: 3 × 55 dense draws plus one more
    per diagonal block from the skip loop on the spent iterator."""
    class Counting(random.Random):
        calls = 0

        def random(self):
            Counting.calls += 1
            return super().random()

    ttopo._stochastic_block_graph([11, 11, 11],
                                  [[0.5 if i == j else 0.0 for j in range(3)]
                                   for i in range(3)], Counting(0))
    assert Counting.calls == 168


def test_paper_topology_suite_equals_reference():
    got = ttopo.paper_topology_suite(0)
    # the reference's docstring says 12 settings; it builds 13 (BA p 1-3,
    # SB p_out x3, BA n 8-64, WS n 8-33)
    assert [name for name, _ in got] == SUITE_NAMES and len(got) == 13
    for (_, t), (_, j) in zip(got, SUITE):
        assert np.array_equal(t.adjacency, j.adjacency)
        assert (t.name, t.seed) == (j.name, j.seed)


@pytest.mark.parametrize("i", range(len(GRAPHS)), ids=GRAPH_IDS)
def test_graph_views_equal_reference(i):
    jt = GRAPHS[i]
    tt = ttopo.from_adjacency(jt.adjacency)
    assert tt.is_connected() == jt.is_connected()
    assert tt.max_degree() == jt.max_degree()
    for k in range(tt.n_nodes):
        assert np.array_equal(tt.neighborhood(k), jt.neighborhood(k))
    for a, b in zip(tt.edge_list(), jt.edge_list()):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    for a, b in zip(ttopo.coo_edge_list(jt.adjacency),
                    jtopo.coo_edge_list(jt.adjacency)):
        assert np.array_equal(a, b)
    for a, b in zip(tt.neighbor_tables(False), jt.neighbor_tables(False)):
        assert np.array_equal(a, b)


def test_builders_and_errors():
    assert sorted(ttopo.TOPOLOGY_BUILDERS) == sorted(jtopo.TOPOLOGY_BUILDERS)
    for kind, kw in (("ba", dict(n=16, p=2, seed=3)), ("sb", dict(n=16)),
                     ("ws", dict(n=16, seed=1)), ("ring", dict(n=5)),
                     ("star", dict(n=5)), ("full", dict(n=4))):
        assert np.array_equal(ttopo.build_topology(kind, **kw).adjacency,
                              jtopo.build_topology(kind, **kw).adjacency)
    with pytest.raises(KeyError) as jerr:
        jtopo.build_topology("grid")
    with pytest.raises(KeyError) as terr:
        ttopo.build_topology("grid")
    assert str(terr.value) == str(jerr.value)
    a = jtopo.ring(6).adjacency
    assert ttopo.from_adjacency(a, "r").name == jtopo.from_adjacency(a, "r").name
