"""Every aggregation strategy of the reference's ``STRATEGIES`` on the
port's host path: the float64 mixing matrix against
``repro.core.strategies.mixing_matrix`` on the paper's topology suite,
the score vectors, ``random_round_seed`` and the per-round matrices of
``AggregationStrategy.matrix(round_idx=)``."""
import numpy as np
import pytest
import torch

from repro.core import strategies as jstrat
from repro.core import topology as jtopo
from repro_torch.core import strategies as tstrat
from repro_torch.core import topology as ttopo

torch.set_num_threads(2)
pytest.importorskip("networkx")

SUITE = jtopo.paper_topology_suite(0)
KINDS = sorted(jstrat.STRATEGIES)


def _port(jt):
    return ttopo.Topology(jt.adjacency, name=jt.name, seed=jt.seed)


def test_the_kinds_are_the_reference_kinds():
    assert sorted(tstrat.STRATEGIES) == KINDS
    assert tstrat.TOPOLOGY_AWARE == jstrat.TOPOLOGY_AWARE
    assert tstrat.TOPOLOGY_UNAWARE == jstrat.TOPOLOGY_UNAWARE


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("i", range(len(SUITE)),
                         ids=[name for name, _ in SUITE])
def test_mixing_matrix_matches_reference(kind, i):
    """Measured: 0 for every kind but eigenvector (LAPACK eigh against
    ARPACK scores, 3e-15 before τ = 0.1 scales them). Pinned: 1e-12."""
    _, jt = SUITE[i]
    counts = np.random.default_rng(i).integers(5, 50, jt.n_nodes)
    strat = dict(kind=kind, tau=0.1, seed=i)
    want = jstrat.mixing_matrix(jt, jstrat.AggregationStrategy(**strat),
                                data_counts=counts)
    got = tstrat.mixing_matrix(_port(jt), tstrat.AggregationStrategy(**strat),
                               data_counts=counts)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", sorted(jstrat.TOPOLOGY_AWARE | {"random"}))
@pytest.mark.parametrize("i", [0, 4, 11])
def test_strategy_scores_match_reference(kind, i):
    _, jt = SUITE[i]
    strat = dict(kind=kind, seed=5)
    np.testing.assert_allclose(
        tstrat.strategy_scores(_port(jt), tstrat.AggregationStrategy(**strat)),
        jstrat.strategy_scores(jt, jstrat.AggregationStrategy(**strat)),
        rtol=0, atol=1e-12)


def test_strategy_scores_refuse_linear_kinds():
    for mod, topo in ((jstrat, jtopo.ring(4)), (tstrat, ttopo.ring(4))):
        with pytest.raises(KeyError):
            mod.strategy_scores(topo, mod.AggregationStrategy("unweighted"))


@pytest.mark.parametrize("seed", [0, 3, 2 ** 20])
def test_random_round_seed_matches_reference(seed):
    for r in (0, 1, 39, 1000):
        assert tstrat.random_round_seed(seed, r) == \
            jstrat.random_round_seed(seed, r)


@pytest.mark.parametrize("kind", ["random", "betweenness", "metropolis"])
def test_matrix_by_round_matches_reference(kind):
    """``matrix(round_idx=r)`` is round r's f32 trainer matrix: the
    program's threefry draw for ``random`` (a new one each round), the
    host matrix cast to f32 for ``metropolis``.  Pinned as the degree
    kind's coefficient programs: 1e-7 plus one ulp."""
    jt = jtopo.barabasi_albert(16, 2, 1)
    js = jstrat.AggregationStrategy(kind, seed=2)
    ts = tstrat.AggregationStrategy(kind, seed=2)
    mats = []
    for r in (0, 1):
        got = ts.matrix(_port(jt), round_idx=r)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, js.matrix(jt, round_idx=r),
                                   rtol=2.0 ** -23, atol=1e-7)
        mats.append(got)
    assert (kind == "random") != np.array_equal(*mats)
    np.testing.assert_allclose(ts.matrix(_port(jt)), js.matrix(jt),
                               rtol=0, atol=1e-12)
