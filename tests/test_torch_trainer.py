"""Port parity for Algorithm 1 end to end: ``DecentralizedTrainer.run``
on the CPU against the JAX trainer — the quickstart scenario (BA graph,
OOD data on the hub) at n = 8 for R = 3 rounds, every mix backend."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decentralized as jdec
from repro.core import propagation as jprop
from repro.core import topology as jtopo
from repro.core.strategies import AggregationStrategy as JStrategy
from repro.data import backdoor as jbackdoor
from repro.data import distribution as jdist
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.models import paper_models as jm
from repro.training import optimizer as jopt
from repro_torch.core import decentralized as tdec
from repro_torch.core import propagation as tprop
from repro_torch.core import topology as ttopo
from repro_torch.core.strategies import AggregationStrategy as TStrategy
from repro_torch.interop import params_from_jax
from repro_torch.models import paper_models as tm
from repro_torch.training import optimizer as topt

torch.set_num_threads(2)

N, ROUNDS, EPOCHS, N_TEST = 8, 3, 2, 200


@pytest.fixture(scope="module")
def scenario():
    topo = jtopo.barabasi_albert(N, 2, 0)
    ood = topo.kth_highest_degree_node(1)
    train = jsyn.make_dataset("mnist", 800, seed=0)
    test = jsyn.make_dataset("mnist", N_TEST, seed=123)
    parts = jdist.node_datasets(train, N, ood_node=ood, q=0.1, seed=0)
    batcher = jpipe.NodeBatcher(parts, 16, steps_per_epoch=3,
                                local_epochs=EPOCHS)
    test_iid = jpipe.make_test_batch(test, N_TEST)
    test_ood = jpipe.make_test_batch(jbackdoor.backdoored_testset(test), N_TEST)
    init = jax.jit(jm.ffn_init)(jax.random.key(0))
    return dict(ood=ood, batcher=batcher, test_iid=test_iid,
                test_ood=test_ood, init=jax.tree.map(np.asarray, init))


def _jax_run(sc, strategy, mix_impl, **cfg):
    trainer = jdec.DecentralizedTrainer(
        jtopo.barabasi_albert(N, 2, 0), JStrategy(strategy, tau=0.1),
        jopt.sgd(1e-2), jm.classifier_loss(jm.ffn_apply),
        jm.classifier_accuracy(jm.ffn_apply),
        jdec.DecentralizedConfig(rounds=ROUNDS, local_epochs=EPOCHS,
                                 eval_every=1, mix_impl=mix_impl, **cfg),
        data_counts=sc["batcher"].data_counts())
    params = jdec.stack_params(
        [jax.tree.map(jnp.asarray, sc["init"])] * N)
    _, hist = trainer.run(
        params,
        lambda r: jax.tree.map(jnp.asarray, sc["batcher"].round_batches(r)),
        jax.tree.map(jnp.asarray, sc["test_iid"]),
        jax.tree.map(jnp.asarray, sc["test_ood"]))
    return hist


def _port_trainer(sc, strategy, mix_impl, **cfg):
    return tdec.DecentralizedTrainer(
        ttopo.barabasi_albert(N, 2, 0), TStrategy(strategy, tau=0.1),
        topt.sgd(1e-2), tm.classifier_loss(tm.ffn_apply),
        tm.classifier_accuracy(tm.ffn_apply),
        tdec.DecentralizedConfig(rounds=ROUNDS, local_epochs=EPOCHS,
                                 eval_every=1, mix_impl=mix_impl, **cfg),
        data_counts=sc["batcher"].data_counts(), device="cpu")


def _port_params(sc):
    return tdec.stack_params([params_from_jax(sc["init"], "cpu")] * N)


@pytest.mark.parametrize("mix_impl", ["einsum", "pallas", "edges"])
@pytest.mark.parametrize("strategy", ["unweighted", "degree"])
def test_trainer_matches_reference(scenario, strategy, mix_impl):
    """Per-node accuracies after each round agree to within one eval
    sample.  Measured drift on this scenario: 0 samples (the same correct
    count on every node, every round) for every strategy × backend, and
    train losses to 1.8e-7 relative.  Pinned: ≤ 1 of the 200 eval samples
    per node, losses to 1e-6 relative."""
    ref = _jax_run(scenario, strategy, mix_impl)
    _, hist = _port_trainer(scenario, strategy, mix_impl).run(
        _port_params(scenario), scenario["batcher"].round_batches,
        scenario["test_iid"], scenario["test_ood"])
    assert [m.round for m in hist] == [m.round for m in ref]
    for a, b in zip(hist, ref):
        for key in ("iid_acc", "ood_acc"):
            drift = np.abs(getattr(a, key) - np.asarray(getattr(b, key)))
            assert drift.max() * N_TEST <= 1 + 1e-3
        np.testing.assert_allclose(a.train_loss, np.asarray(b.train_loss),
                                   rtol=1e-6)
    for which in ("iid", "ood"):
        assert tprop.accuracy_auc(hist, which) == pytest.approx(
            jprop.accuracy_auc(ref, which), abs=1.0 / N_TEST)


@pytest.mark.parametrize("robust,mix_impl", [
    ("trimmed", "einsum"), ("trimmed", "edges"), ("median", "edges"),
    ("norm_clip", "pallas"), ("norm_clip", "edges")])
def test_robust_trainer_matches_reference(scenario, robust, mix_impl):
    """The robust rules through ``DecentralizedTrainer`` (the ``degree``
    strategy, trimmed with robust_trim = 1) against the JAX trainer.
    Measured: 0 eval samples apart on every node and round, train losses
    to 2.1e-7 relative.  Pinned as the mean trainer: ≤ 1 of the 200 eval
    samples per node, losses to 1e-6 relative."""
    cfg = dict(robust=robust, robust_trim=1, robust_clip=1.0)
    ref = _jax_run(scenario, "degree", mix_impl, **cfg)
    _, hist = _port_trainer(scenario, "degree", mix_impl, **cfg).run(
        _port_params(scenario), scenario["batcher"].round_batches,
        scenario["test_iid"], scenario["test_ood"])
    assert [m.round for m in hist] == [m.round for m in ref]
    for a, b in zip(hist, ref):
        for key in ("iid_acc", "ood_acc"):
            drift = np.abs(getattr(a, key) - np.asarray(getattr(b, key)))
            assert drift.max() * N_TEST <= 1 + 1e-3
        np.testing.assert_allclose(a.train_loss, np.asarray(b.train_loss),
                                   rtol=1e-6)


def test_run_and_run_unrolled_give_the_same_history(scenario):
    runs = []
    for unroll in (False, True):
        tr = _port_trainer(scenario, "degree", "pallas", unroll_eval=unroll)
        final, hist = tr.run(_port_params(scenario),
                             scenario["batcher"].round_batches,
                             scenario["test_iid"], scenario["test_ood"])
        runs.append((final, hist))
    (fa, ha), (fb, hb) = runs
    for a, b in zip(ha, hb):
        assert a.round == b.round
        for key in ("iid_acc", "ood_acc", "train_loss"):
            assert np.array_equal(getattr(a, key), getattr(b, key))
    for a, b in zip(jax.tree.leaves(fa), jax.tree.leaves(fb)):
        assert torch.equal(a, b)
