"""Port parity for the host-side numpy layer: topology, data, batching and
the propagation metrics must match the JAX package EXACTLY
(``np.array_equal``) on the same inputs."""
import networkx as nx
import numpy as np
import pytest
import torch

from repro.core import propagation as jprop
from repro.core import topology as jtopo
from repro.core.decentralized import RoundMetrics as JRoundMetrics
from repro.data import backdoor as jbackdoor
from repro.data import distribution as jdist
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro_torch.core import propagation as tprop
from repro_torch.core import topology as ttopo
from repro_torch.core.decentralized import RoundMetrics as TRoundMetrics
from repro_torch.data import backdoor as tbackdoor
from repro_torch.data import distribution as tdist
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic as tsyn

torch.set_num_threads(2)


@pytest.mark.parametrize("n,p,seed", [(33, 2, 0), (16, 2, 0), (8, 3, 5),
                                      (50, 1, 7), (64, 2, 3), (12, 11, 1)])
def test_barabasi_albert_matches_networkx(n, p, seed):
    ref = nx.to_numpy_array(nx.barabasi_albert_graph(n=n, m=p, seed=seed))
    port = ttopo.barabasi_albert(n, p, seed)
    assert np.array_equal(port.adjacency, ref)
    assert np.array_equal(port.adjacency,
                          jtopo.barabasi_albert(n, p, seed).adjacency)


@pytest.mark.parametrize("make", [
    lambda m: m.barabasi_albert(33, 2, 0),
    lambda m: m.barabasi_albert(16, 3, 4),
    lambda m: m.ring(9),
    lambda m: m.star(7),
])
def test_neighbor_tables_and_degree_ranks(make):
    jt, tt = make(jtopo), make(ttopo)
    for include_self in (True, False):
        for a, b in zip(jt.neighbor_tables(include_self),
                        tt.neighbor_tables(include_self)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(jt.nodes_by_degree(), tt.nodes_by_degree())
    for k in range(1, jt.n_nodes + 1):
        assert jt.kth_highest_degree_node(k) == tt.kth_highest_degree_node(k)


def test_padded_neighbor_tables_arbitrary_support():
    rng = np.random.default_rng(0)
    s = (rng.random((11, 11)) < 0.3).astype(np.float64)
    s[3] = 0.0  # an empty row comes back all padding
    for a, b in zip(jtopo.padded_neighbor_tables(s),
                    ttopo.padded_neighbor_tables(s)):
        assert np.array_equal(a, b)


def _assert_dataset_equal(a, b):
    assert np.array_equal(a.x, b.x) and a.x.dtype == b.x.dtype
    assert np.array_equal(a.y, b.y) and a.y.dtype == b.y.dtype
    assert (a.kind, a.n_classes) == (b.kind, b.n_classes)


@pytest.mark.parametrize("name", ["mnist", "cifar10"])
def test_datasets_node_split_and_backdoor(name):
    jtrain, ttrain = jsyn.make_dataset(name, 300, 0), tsyn.make_dataset(
        name, 300, 0)
    _assert_dataset_equal(jtrain, ttrain)
    for ood in (3, [1, 4], None):
        jparts = jdist.node_datasets(jtrain, 6, ood_node=ood, q=0.1, seed=2)
        tparts = tdist.node_datasets(ttrain, 6, ood_node=ood, q=0.1, seed=2)
        for a, b in zip(jparts, tparts):
            _assert_dataset_equal(a, b)
    jtest, ttest = jsyn.make_dataset(name, 50, 123), tsyn.make_dataset(
        name, 50, 123)
    _assert_dataset_equal(jbackdoor.backdoored_testset(jtest),
                          tbackdoor.backdoored_testset(ttest))


@pytest.mark.parametrize("steps,epochs,batch", [(0, 5, 8), (3, 2, 4)])
def test_node_batcher_and_test_batch(steps, epochs, batch):
    train = jsyn.make_dataset("mnist", 240, 0)
    parts = jdist.node_datasets(train, 5, ood_node=0, q=0.1, seed=0)
    jb = jpipe.NodeBatcher(parts, batch, steps_per_epoch=steps, seed=1,
                           local_epochs=epochs)
    tb = tpipe.NodeBatcher(tdist.node_datasets(
        tsyn.make_dataset("mnist", 240, 0), 5, ood_node=0, q=0.1, seed=0),
        batch, steps_per_epoch=steps, seed=1, local_epochs=epochs)
    assert np.array_equal(jb.data_counts(), tb.data_counts())
    for r in (0, 1, 7):
        assert np.array_equal(jb.round_indices(r), tb.round_indices(r))
        jr, tr = jb.round_batches(r), tb.round_batches(r)
        assert sorted(jr) == sorted(tr)
        for k in jr:
            assert jr[k].dtype == tr[k].dtype and np.array_equal(jr[k], tr[k])
    test = jsyn.make_dataset("mnist", 90, 123)
    for n, seed in ((512, 0), (40, 3)):
        ja = jpipe.make_test_batch(test, n, seed=seed)
        ta = tpipe.make_test_batch(tsyn.make_dataset("mnist", 90, 123), n,
                                   seed=seed)
        for k in ja:
            assert np.array_equal(ja[k], ta[k])


def test_propagation_metrics_on_the_same_history():
    rng = np.random.default_rng(0)
    rounds = [1, 3, 5, 6]
    acc = rng.random((len(rounds), 2, 9)).astype(np.float32)
    loss = rng.random((len(rounds), 9)).astype(np.float32)
    jh = [JRoundMetrics(r, acc[i, 0], acc[i, 1], loss[i])
          for i, r in enumerate(rounds)]
    th = [TRoundMetrics(r, acc[i, 0], acc[i, 1], loss[i])
          for i, r in enumerate(rounds)]
    for which in ("iid", "ood"):
        assert np.array_equal(jprop.per_node_auc(jh, which),
                              tprop.per_node_auc(th, which))
        assert jprop.accuracy_auc(jh, which) == tprop.accuracy_auc(th, which)
        assert np.array_equal(jprop.per_node_auc(jh[:1], which),
                              tprop.per_node_auc(th[:1], which))
    topo = jtopo.barabasi_albert(9, 1, 2)
    a = topo.adjacency.copy()
    a[8, :] = a[:, 8] = 0.0   # an unreachable node
    for src in (0, [2, 5], np.array([7])):
        assert np.array_equal(jprop.hops_from(a, src),
                              tprop.hops_from(a, src))
    assert (jprop.render_propagation_map(jh, a, 0)
            == tprop.render_propagation_map(th, a, 0))
