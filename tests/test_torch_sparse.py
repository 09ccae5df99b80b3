"""Port parity for the circulant (``sparse``) backend and the float64 host
path of the strategies: the ring-offset schedule and its fallback
decision, ``mix_sparse`` / ``mix_sparse_host``, the connected
Watts–Strogatz generator, ``metropolis_hastings`` and ``mixing_matrix``,
and the trainer with ``mix_impl="sparse"`` — each against the JAX
package (networkx behind its generators)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decentralized as jdec
from repro.core import mixing as jmix
from repro.core import strategies as jstrat
from repro.core import topology as jtopo
from repro.data import backdoor as jbackdoor
from repro.data import distribution as jdist
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.models import paper_models as jm
from repro.training import optimizer as jopt
from repro_torch.core import decentralized as tdec
from repro_torch.core import mixing as tmix
from repro_torch.core import strategies as tstrat
from repro_torch.core import topology as ttopo
from repro_torch.interop import params_from_jax
from repro_torch.models import paper_models as tm
from repro_torch.training import optimizer as topt

torch.set_num_threads(2)

DEGREE_J = jstrat.AggregationStrategy("degree", tau=0.1)
DEGREE_T = tstrat.AggregationStrategy("degree", tau=0.1)


def _study_topologies():
    """The reference's paper suite (seed 0) and the schedule study's four
    graphs, as (name, reference topology)."""
    return list(jtopo.paper_topology_suite(0)) + [
        ("ring16", jtopo.ring(16)),
        ("ba16_p1", jtopo.barabasi_albert(16, 1, seed=0)),
        ("ba16_p2", jtopo.barabasi_albert(16, 2, seed=0)),
        ("ws16", jtopo.watts_strogatz(16, 4, 0.5, seed=0)),
    ]


TOPOS = _study_topologies()
NAMES = [name for name, _ in TOPOS]


def _port_topo(jt):
    return ttopo.Topology(np.asarray(jt.adjacency))


@pytest.mark.parametrize("i", range(len(TOPOS)), ids=NAMES)
def test_schedule_and_fallback_equal_reference(i):
    """``sparse_offsets``, ``sparse_schedule`` (offsets, coverage and the
    dense-fallback decision, at the default slack and at 0) and
    ``circulant_decomposition`` of the host ``degree`` matrix, equal."""
    _, jt = TOPOS[i]
    support = jt.adjacency + np.eye(jt.n_nodes)
    assert tmix.sparse_offsets(support) == jmix.sparse_offsets(support)
    for slack in (4, 0):
        got = tdec.sparse_schedule(support, slack)
        want = jdec.sparse_schedule(support, slack)
        assert (got[0] is None) == (want[0] is None)
        if want[0] is not None:
            assert got[0] == want[0]
            assert np.array_equal(got[1], want[1])
    c_port = tstrat.mixing_matrix(_port_topo(jt), DEGREE_T)
    c_ref = jstrat.mixing_matrix(jt, DEGREE_J)
    assert c_port.dtype == np.float64 and np.array_equal(c_port, c_ref)
    got, want = (tmix.circulant_decomposition(c_port),
                 jmix.circulant_decomposition(c_ref))
    assert got.offsets == want.offsets and got.n == want.n
    assert np.array_equal(got.weights, want.weights)
    for sched in (None, got):
        ref_sched = None if sched is None else want
        assert tmix.mixing_collective_bytes(jt.n_nodes, 4_000_000, sched) == \
            jmix.mixing_collective_bytes(jt.n_nodes, 4_000_000, ref_sched)


def test_fallback_fires_on_the_paper_graphs_but_not_on_rings():
    """The finding the trainer's ``mix_impl="sparse"`` rests on: BA(33, 2)
    (the quickstart's graph) and BA(16, 2) fall back to the einsum; ring(33),
    ring(8) and BA(8, 2) keep the ring schedule."""
    def falls_back(topo):
        sup = topo.adjacency + np.eye(topo.n_nodes)
        port = tdec.sparse_schedule(sup)[0] is None
        assert port == (jdec.sparse_schedule(sup)[0] is None)
        return port

    assert falls_back(jtopo.barabasi_albert(33, 2, 0))
    assert falls_back(jtopo.barabasi_albert(16, 2, 0))
    assert not falls_back(jtopo.ring(33))
    assert not falls_back(jtopo.ring(8))
    assert not falls_back(jtopo.barabasi_albert(8, 2, 0))
    assert tdec.sparse_schedule(jtopo.ring(33).adjacency + np.eye(33))[0] \
        == (0, 1, 32)


def _tree(n, seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(n, 3, 50)).astype(np.float32),
            "b": rng.normal(size=(n,)).astype(np.float32)}


@pytest.mark.parametrize("name", ["ring8", "ba8", "ws16", "ba16"])
@pytest.mark.parametrize("f32", [True, False])
def test_mix_sparse_equals_reference(name, f32):
    """``mix_sparse`` (live f32 weights) and ``mix_sparse_host`` (the
    schedule's own weights) against the reference on random row-stochastic
    matrices over the support.  Both sum the same rounded products in the
    same offset order: measured bit-identical in f32 and in the bf16
    ablation (``mix_in_float32=False`` sums in bf16 by design, as the
    reference does), so pinned exact."""
    jt = {"ring8": jtopo.ring(8), "ba8": jtopo.barabasi_albert(8, 2, 0),
          "ws16": jtopo.watts_strogatz(16, 4, 0.5, 0),
          "ba16": jtopo.barabasi_albert(16, 2, 0)}[name]
    n = jt.n_nodes
    rng = np.random.default_rng(n)
    sup = jt.adjacency + np.eye(n)
    c = (rng.random((n, n)) * sup).astype(np.float32)
    c = (c / c.sum(1, keepdims=True)).astype(np.float32)
    offs = jmix.sparse_offsets(sup)
    tree = _tree(n, n + 1)
    jdt, tdt = ((jnp.float32, torch.float32) if f32
                else (jnp.bfloat16, torch.bfloat16))
    ref = jmix.mix_sparse({k: jnp.asarray(v).astype(jdt)
                           for k, v in tree.items()}, jnp.asarray(c), offs,
                          mix_in_float32=f32)
    out = tmix.mix_sparse({k: torch.as_tensor(v).to(tdt)
                           for k, v in tree.items()}, torch.as_tensor(c),
                          offs, mix_in_float32=f32)
    for k in tree:
        assert out[k].dtype == tdt
        assert np.array_equal(out[k].float().numpy(),
                              np.asarray(ref[k], np.float32))
    if f32:
        ref = jmix.mix_sparse_host(jax.tree.map(jnp.asarray, tree),
                                   jmix.circulant_decomposition(c))
        out = tmix.mix_sparse_host(
            {k: torch.as_tensor(v) for k, v in tree.items()},
            tmix.circulant_decomposition(c))
        for k in tree:
            assert np.array_equal(out[k].numpy(), np.asarray(ref[k]))


# networkx's connected Watts–Strogatz: fig6's (n, 4, 0.5) at n = 8, 16, 24,
# the paper suite's n = 33, and other (n, k, u) at five seeds each;
# (16, 2, 0.5, seed 8) is disconnected on the first try
WS_CASES = ([(n, 4, 0.5, s) for n in (8, 16, 24, 33) for s in range(5)]
            + [(n, k, u, s) for n, k, u in ((10, 2, 0.9), (12, 6, 0.1),
                                            (20, 3, 0.3), (64, 4, 1.0))
               for s in range(5)]
            + [(16, 2, 0.5, 8)])


@pytest.mark.parametrize("n,k,u,seed", WS_CASES)
def test_watts_strogatz_equals_networkx(n, k, u, seed):
    ref = jtopo.watts_strogatz(n, k, u, seed)
    got = ttopo.watts_strogatz(n, k, u, seed)
    assert np.array_equal(got.adjacency, ref.adjacency)
    assert got.name == ref.name and got.seed == ref.seed


def test_watts_strogatz_retry_case_needs_a_retry():
    """The retry case above: networkx's first draw from ``Random(8)`` is
    disconnected, so its graph is the second draw of the same stream."""
    import random

    import networkx as nx

    first = nx.watts_strogatz_graph(16, 2, 0.5, seed=random.Random(8))
    assert not nx.is_connected(first)
    assert ttopo._is_connected(ttopo.watts_strogatz(16, 2, 0.5, 8).adjacency)


def test_fully_connected_and_neighbors():
    for n in (2, 5, 33):
        got, ref = ttopo.fully_connected(n), jtopo.fully_connected(n)
        assert np.array_equal(got.adjacency, ref.adjacency)
        assert got.name == ref.name
    jt = jtopo.barabasi_albert(16, 2, 0)
    for i in range(16):
        assert np.array_equal(_port_topo(jt).neighbors(i), jt.neighbors(i))


@pytest.mark.parametrize("kind", ["metropolis", "degree", "unweighted",
                                  "weighted", "fl"])
@pytest.mark.parametrize("i", [0, 2, 3, 7, 9, 11, 15], ids=lambda i: NAMES[i])
def test_host_matrices_equal_reference(kind, i):
    """The float64 host path, numpy op for op: measured bit-identical for
    every kind on these graphs, so pinned to 1e-15 (and equal dtype)."""
    _, jt = TOPOS[i]
    counts = np.random.default_rng(i).integers(5, 50, jt.n_nodes)
    got = tstrat.mixing_matrix(_port_topo(jt),
                               tstrat.AggregationStrategy(kind, tau=0.1),
                               data_counts=counts)
    want = jstrat.mixing_matrix(jt, jstrat.AggregationStrategy(kind, tau=0.1),
                                data_counts=counts)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def test_host_path_raises_for_what_it_lacks():
    """Every reference kind has a host matrix now; what the host path
    lacks is an answer where the reference has none: eigenvector
    centrality on a disconnected graph (networkx: AmbiguousSolution)."""
    topo = ttopo.ring(5)
    split = ttopo.from_adjacency(np.kron(np.eye(2), np.ones((3, 3)))
                                 - np.eye(6))
    for kind in ("random", "betweenness", "eigenvector", "pagerank",
                 "closeness"):
        tstrat.mixing_matrix(topo, tstrat.AggregationStrategy(kind))
    with pytest.raises(ttopo.AmbiguousSolution):
        tstrat.mixing_matrix(split, tstrat.AggregationStrategy("eigenvector"))
    with pytest.raises(KeyError):
        tstrat.mixing_matrix(topo, tstrat.AggregationStrategy("krum"))
    with pytest.raises(ValueError, match="data_counts"):
        tstrat.mixing_matrix(topo, tstrat.AggregationStrategy("weighted"))
    bad = np.eye(5)
    bad[0, 2], bad[0, 0] = 0.5, 0.5     # weight outside node 0's neighbours
    with pytest.raises(ValueError, match="outside"):
        tstrat.validate_mixing_matrix(bad, topo)


def test_metropolis_round_coeffs_take_the_host_path_in_f32():
    """Kinds outside the coefficient program come from the host matrix
    cast to f32, the values the reference's trainer mixes with (JAX runs
    with x64 off)."""
    jt = jtopo.barabasi_albert(16, 2, 0)
    strat = tstrat.AggregationStrategy("metropolis")
    got = tdec.round_coeffs(_port_topo(jt), strat, 3)
    stack = tdec.coeffs_stack(_port_topo(jt), strat, 2)
    want = np.asarray(jnp.asarray(jdec.round_coeffs(
        jt, jstrat.AggregationStrategy("metropolis"), 3)))
    assert got.dtype == stack.dtype == want.dtype == np.float32
    assert np.array_equal(got, want) and np.array_equal(stack[1], want)


def test_make_mix_fn_sparse_dispatch():
    """The ring schedule where it holds, the einsum where it falls back,
    and no schedule without a support."""
    sup_ring = jtopo.ring(8).adjacency + np.eye(8)
    sup_ba = jtopo.barabasi_albert(16, 2, 0).adjacency + np.eye(16)
    assert tdec.make_mix_fn("sparse", mix_support=sup_ba).func \
        is tmix.mix_dense
    mix = tdec.make_mix_fn("sparse", mix_support=sup_ring)
    params = {"a": torch.randn(8, 5)}
    c = torch.as_tensor(jstrat.mixing_matrix(jtopo.ring(8), DEGREE_J),
                        dtype=torch.float32)
    assert torch.equal(mix(params, c)["a"],
                       tmix.mix_sparse(params, c, (0, 1, 7))["a"])
    with pytest.raises(ValueError, match="mix_support"):
        tdec.make_mix_fn("sparse")


# ----------------------------------------------------------------------
# the trainer with mix_impl="sparse" on a ring, against the reference
# ----------------------------------------------------------------------
N, ROUNDS, EPOCHS, N_TEST = 8, 3, 2, 200


@pytest.fixture(scope="module")
def scenario():
    train = jsyn.make_dataset("mnist", 800, seed=0)
    test = jsyn.make_dataset("mnist", N_TEST, seed=123)
    parts = jdist.node_datasets(train, N, ood_node=0, q=0.1, seed=0)
    batcher = jpipe.NodeBatcher(parts, 16, steps_per_epoch=3,
                                local_epochs=EPOCHS)
    init = jax.jit(jm.ffn_init)(jax.random.key(0))
    return dict(batcher=batcher,
                test_iid=jpipe.make_test_batch(test, N_TEST),
                test_ood=jpipe.make_test_batch(
                    jbackdoor.backdoored_testset(test), N_TEST),
                init=jax.tree.map(np.asarray, init))


@pytest.mark.parametrize("graph,strategy", [
    ("ring", "degree"), ("ring", "metropolis"), ("ba", "metropolis")])
def test_sparse_trainer_matches_reference(scenario, graph, strategy):
    """3 rounds with ``mix_impl="sparse"`` where the schedule holds:
    ring(8) (2 nonzero offsets; there ``degree`` and ``metropolis`` give
    the same matrix, 1/3 each) and BA(8, 2) (7 offsets, max degree 5),
    whose ``metropolis`` weights differ by node.  Measured: 0 eval
    samples apart on every node and round, train losses to 2.1e-7
    relative.  Pinned as the other trainer tests: ≤ 1 of the 200 eval
    samples per node, losses to 1e-6."""
    sc = scenario
    cfg = dict(rounds=ROUNDS, local_epochs=EPOCHS, eval_every=1,
               mix_impl="sparse")
    make = {"ring": lambda m: m.ring(N),
            "ba": lambda m: m.barabasi_albert(N, 2, 0)}[graph]
    jtr = jdec.DecentralizedTrainer(
        make(jtopo), jstrat.AggregationStrategy(strategy, tau=0.1),
        jopt.sgd(1e-2), jm.classifier_loss(jm.ffn_apply),
        jm.classifier_accuracy(jm.ffn_apply), jdec.DecentralizedConfig(**cfg),
        data_counts=sc["batcher"].data_counts())
    _, ref = jtr.run(
        jdec.stack_params([jax.tree.map(jnp.asarray, sc["init"])] * N),
        lambda r: jax.tree.map(jnp.asarray, sc["batcher"].round_batches(r)),
        jax.tree.map(jnp.asarray, sc["test_iid"]),
        jax.tree.map(jnp.asarray, sc["test_ood"]))
    ttr = tdec.DecentralizedTrainer(
        make(ttopo), tstrat.AggregationStrategy(strategy, tau=0.1),
        topt.sgd(1e-2), tm.classifier_loss(tm.ffn_apply),
        tm.classifier_accuracy(tm.ffn_apply), tdec.DecentralizedConfig(**cfg),
        data_counts=sc["batcher"].data_counts(), device="cpu")
    _, hist = ttr.run(
        tdec.stack_params([params_from_jax(sc["init"], "cpu")] * N),
        sc["batcher"].round_batches, sc["test_iid"], sc["test_ood"])
    assert [m.round for m in hist] == [m.round for m in ref]
    for a, b in zip(hist, ref):
        for key in ("iid_acc", "ood_acc"):
            drift = np.abs(getattr(a, key) - np.asarray(getattr(b, key)))
            assert drift.max() * N_TEST <= 1 + 1e-3
        np.testing.assert_allclose(a.train_loss, np.asarray(b.train_loss),
                                   rtol=1e-6)
