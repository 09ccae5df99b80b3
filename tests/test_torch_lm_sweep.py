"""Algorithm 1 and the sweep engine on TinyMem, GPT-2 cut to d 64, on the
CPU against the JAX package: one LM round of ``DecentralizedTrainer``, a
two-strategy TinyMem grid of ``SweepEngine`` and of the figure harness
(``run_sweep_cells``), each against a live reference run; LocalTrain and
the evaluation in slices of the node axis against the one-call run (the
evaluation bit for bit).  Each tolerance is stated beside the value
measured here.  The model's, losses' and optimizers' parity is
``tests/test_torch_lm.py``'s, whose helpers this file shares.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decentralized as jdec
from repro.core import propagation as jprop
from repro.core import topology as jtopo
from repro.core.strategies import AggregationStrategy as JStrategy
from repro.core.sweep import SweepEngine as JEngine
from repro.data import backdoor as jbd
from repro.data import distribution as jdist
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.models import paper_models as jm
from repro.training import optimizer as jopt
from repro_torch import tree as tree_util
from repro_torch.core import decentralized as tdec
from repro_torch.core import propagation as tprop
from repro_torch.core import sweep as tsweep
from repro_torch.core import topology as ttopo
from repro_torch.core.strategies import AggregationStrategy as TStrategy
from repro_torch.core.sweep import SweepEngine as TEngine
from repro_torch.interop import params_from_jax
from repro_torch.models import paper_models as tm
from repro_torch.training import optimizer as topt
from tests.test_torch_lm import _init, _jnp, _narrow, _rel, _torch

torch.set_num_threads(2)

# ----------------------------------------------------------------------
# Algorithm 1 and the sweep engine on TinyMem (narrow)
# ----------------------------------------------------------------------
N, ROUNDS, EPOCHS, N_TEST, MAX_LEN = 4, 2, 2, 48, 150


@pytest.fixture(scope="module")
def lm_scenario():
    """BA(4, 2), the language backdoor on half of the hub's rows, TinyMem
    at its 150 tokens, batches of 4 over 3 steps an epoch; the OOD test
    batch holds 591 masked targets."""
    topo = jtopo.barabasi_albert(N, 2, 0)
    ood = topo.kth_highest_degree_node(1)
    train = jsyn.make_tinymem_dataset(400, MAX_LEN, seed=0)
    test = jsyn.make_tinymem_dataset(300, MAX_LEN, seed=9999)
    parts = jdist.node_datasets(train, N, ood_node=ood, q=0.5, seed=0)
    batcher = jpipe.NodeBatcher(parts, 4, steps_per_epoch=3,
                                local_epochs=EPOCHS)
    return dict(ood=ood, batcher=batcher,
                test_iid=jpipe.make_test_batch(test, N_TEST),
                test_ood=jpipe.make_test_batch(jbd.backdoored_testset(test),
                                               N_TEST, ood_mask=True))


def _trainers(sc, strategy):
    jc, tc = _narrow()
    conf = dict(rounds=ROUNDS, local_epochs=EPOCHS, eval_every=1,
                mix_impl="einsum")
    counts = sc["batcher"].data_counts()
    jtr = jdec.DecentralizedTrainer(
        jtopo.barabasi_albert(N, 2, 0), JStrategy(strategy, tau=0.1),
        jopt.adam(1e-3), jm.lm_loss(jc), jm.lm_accuracy(jc),
        jdec.DecentralizedConfig(**conf), data_counts=counts)
    ttr = tdec.DecentralizedTrainer(
        ttopo.barabasi_albert(N, 2, 0), TStrategy(strategy, tau=0.1),
        topt.adam(1e-3), tm.lm_loss(tc), tm.lm_accuracy(tc),
        tdec.DecentralizedConfig(**conf), data_counts=counts,
        device="cpu")
    return jc, jtr, ttr


def _masked_targets(batch):
    return float(batch["mask"].sum()) if "mask" in batch else \
        float(np.prod(batch["tokens"].shape) - batch["tokens"].shape[0])


def test_trainer_lm_round_matches_reference(lm_scenario):
    """Two rounds of Algorithm 1 with the LM at n = 4 (degree, Adam 1e-3),
    the reference's init carried over.  Measured: per-node accuracies
    equal on every round (0 eval targets apart of the IID set's 7,152
    and the OOD set's 591), train losses within 1.2e-7 relative.
    Pinned: at most 1 eval target apart per node, losses 2e-6
    relative."""
    sc = lm_scenario
    jc, jtr, ttr = _trainers(sc, "degree")
    _, np_tree, _ = _init(jc)
    stack = jax.tree.map(lambda a: np.stack([a] * N), np_tree)
    _, ref = jtr.run(_jnp(stack),
                     lambda r: _jnp(sc["batcher"].round_batches(r)),
                     _jnp(sc["test_iid"]), _jnp(sc["test_ood"]))
    _, hist = ttr.run(params_from_jax(stack, "cpu"),
                      sc["batcher"].round_batches, sc["test_iid"],
                      sc["test_ood"])
    targets = {"iid_acc": _masked_targets(sc["test_iid"]),
               "ood_acc": _masked_targets(sc["test_ood"])}
    assert [m.round for m in hist] == [m.round for m in ref]
    for a, b in zip(hist, ref):
        assert np.all(np.isfinite(a.train_loss))
        for key, count in targets.items():
            drift = np.abs(getattr(a, key) - np.asarray(getattr(b, key)))
            assert drift.max() * count <= 1 + 1e-3, key
        np.testing.assert_allclose(a.train_loss, np.asarray(b.train_loss),
                                   rtol=2e-6)
    assert hist[1].train_loss.mean() < hist[0].train_loss.mean()
    for which in ("iid", "ood"):
        assert tprop.accuracy_auc(hist, which) == pytest.approx(
            jprop.accuracy_auc(ref, which), abs=1e-6)


def _set_budget(monkeypatch, sc, kind, rows):
    """A node budget (``core.decentralized.node_budget``, which the CPU
    leaves unlimited) of ``rows`` nodes' ``working_bytes``: of a
    LocalTrain step (``"train"``; the evaluation then takes one node a
    call, its bytes being larger) or of an evaluation (``"eval"``;
    LocalTrain then takes every node at once)."""
    tc = _narrow()[1]
    if kind == "train":
        nbytes = rows * tm.lm_train_bytes(tc, {"tokens": np.zeros((4, 150))})
    else:
        nbytes = rows * tm.lm_eval_bytes(tc, sc["test_iid"])
    for module in (tdec, tsweep):
        monkeypatch.setattr(module, "node_budget", lambda device: nbytes)


@pytest.mark.parametrize("rows", [4, 6, 7])
def test_local_train_slices_hold_whole_experiments(lm_scenario, monkeypatch,
                                                   rows):
    """LocalTrain over E = 2 folded experiments of n = 4 nodes under a
    budget of 4, 6 or 7 nodes' gradients takes one whole experiment a
    call, so each experiment's params and Adam state equal, bit for bit,
    its own LocalTrain in one call (slices of 7 + 1 nodes part from it on
    the CPU).  The mean loss over the steps is reduced over 8 nodes
    instead of 4, which moves it by an ulp on the CPU: pinned at 1e-6
    relative, measured 8.2e-8."""
    _, tc = _narrow()
    local = tdec.make_local_train_fn(tm.lm_loss(tc), topt.adam(1e-3), EPOCHS)
    batches = _torch(lm_scenario["batcher"].round_batches(0))
    inits = [_init(_narrow()[0], seed)[1] for seed in (0, 1)]
    exps = [params_from_jax(jax.tree.map(lambda a: np.stack([a] * N), t),
                            "cpu") for t in inits]
    alone = [local(p, topt.adam(1e-3).init(p), batches) for p in exps]
    folded = tree_util.tree_map(lambda *xs: torch.cat(xs), *exps)
    twice = tree_util.tree_map(lambda x: torch.cat([x, x]), batches)
    step = {"tokens": np.zeros((4, MAX_LEN))}
    nbytes = rows * tm.lm_train_bytes(tc, step)
    monkeypatch.setattr(tdec, "node_budget", lambda device: nbytes)
    got = local(folded, topt.adam(1e-3).init(folded), twice, 2)
    want = [tree_util.tree_map(lambda *xs: torch.cat(xs), *parts)
            for parts in zip(*alone)]
    for a, b in zip(tree_util.leaves(got[:2]), tree_util.leaves(want[:2])):
        assert torch.equal(a, b)
    assert _rel(got[2], want[2]) <= 1e-6


def _same_or_close(kind, hist, base, params, base_params, targets):
    """An evaluation in slices gives the one-call history bit for bit.
    Gradients in slices take the products in batches of another count,
    which moves a loss by an ulp on the CPU: per-node accuracies within
    one eval target, losses within 2e-6 relative, params within 1e-4 (a
    tenth of Adam's rate 1e-3; Adam moves an entry whose gradient is
    rounding noise by up to its rate).  Measured over two rounds:
    accuracies equal, losses within 1.2e-7 relative, params within
    1.2e-7."""
    for key in ("iid_acc", "ood_acc", "train_loss"):
        a, b = np.asarray(hist[key]), np.asarray(base[key])
        if kind == "eval":
            assert np.array_equal(a, b), key
        elif key == "train_loss":
            np.testing.assert_allclose(a, b, rtol=2e-6)
        else:
            assert np.abs(a - b).max() * targets[key] <= 1 + 1e-3, key
    for x, y in zip(tree_util.leaves(params), tree_util.leaves(base_params)):
        if kind == "eval":
            assert torch.equal(x, y)
        else:
            assert float((x - y).abs().max()) <= 1e-4


def _targets(sc):
    return {"iid_acc": _masked_targets(sc["test_iid"]),
            "ood_acc": _masked_targets(sc["test_ood"])}


def _stacked_history(hist):
    return {k: np.stack([getattr(m, k) for m in hist])
            for k in ("iid_acc", "ood_acc", "train_loss")}


@pytest.mark.parametrize("kind,rows", [("train", 1), ("train", 3),
                                       ("eval", 3)])
def test_trainer_in_node_slices_matches_one_call(lm_scenario, monkeypatch,
                                                 kind, rows):
    """LocalTrain's gradients (and the evaluation) over slices of the node
    axis that a small node budget forces, against the trainer's one-call
    run (``_same_or_close``)."""
    sc = lm_scenario
    jc, _, one_call = _trainers(sc, "unweighted")
    _, np_tree, _ = _init(jc)
    stack = jax.tree.map(lambda a: np.stack([a] * N), np_tree)
    base = one_call.run(params_from_jax(stack, "cpu"),
                        sc["batcher"].round_batches, sc["test_iid"],
                        sc["test_ood"])
    _set_budget(monkeypatch, sc, kind, rows)
    _, _, sliced = _trainers(sc, "unweighted")
    out = sliced.run(params_from_jax(stack, "cpu"),
                     sc["batcher"].round_batches, sc["test_iid"],
                     sc["test_ood"])
    _same_or_close(kind, _stacked_history(out[1]),
                   _stacked_history(base[1]), out[0], base[0], _targets(sc))


def _grid_inputs(sc, strategies):
    """Both engines' inputs for ``strategies`` on one bank row."""
    jc, tc = _narrow()
    _, np_tree, _ = _init(jc)
    topo = jtopo.barabasi_albert(N, 2, 0)
    e = len(strategies)
    counts = sc["batcher"].data_counts()
    coeffs = np.stack([jdec.coeffs_stack(topo, JStrategy(s, tau=0.1),
                                         ROUNDS, counts) for s in strategies])
    params0 = jax.tree.map(lambda a: np.stack([np.stack([a] * N)] * e),
                           np_tree)
    bank = {k: v[None] for k, v in sc["batcher"].sample_bank().items()}
    indices = sc["batcher"].all_round_indices(ROUNDS)[None]
    tests = [{k: np.stack([v] * e) for k, v in t.items()}
             for t in (sc["test_iid"], sc["test_ood"])]
    return jc, tc, (params0, coeffs, bank, indices, np.zeros(e, np.int64),
                    *tests)


GRID_CONF = dict(rounds=ROUNDS, local_epochs=EPOCHS, eval_every=1)


def _port_engine(tc):
    return TEngine(topt.adam(1e-3), tm.lm_loss(tc), tm.lm_accuracy(tc),
                   tdec.DecentralizedConfig(**GRID_CONF), device="cpu")


@pytest.fixture(scope="module")
def lm_grid(lm_scenario):
    """``unweighted`` against ``degree`` as one TinyMem grid (E = 2, n =
    4, R = 2): the reference engine's run and the port's, one
    evaluation call a test set."""
    sc = lm_scenario
    jc, tc, args = _grid_inputs(sc, ("unweighted", "degree"))
    jres = JEngine(jopt.adam(1e-3), jm.lm_loss(jc), jm.lm_accuracy(jc),
                   jdec.DecentralizedConfig(**GRID_CONF)).run(
        *jax.tree.map(jnp.asarray, args), batch_size=4)
    targs = (params_from_jax(args[0], "cpu"),) + args[1:]
    return tc, targs, jres, _port_engine(tc).run(*targs, batch_size=4)


def test_sweep_engine_tinymem_grid_matches_reference(lm_scenario, lm_grid):
    """The port's engine against the reference's on the TinyMem grid.
    Measured: accuracies equal, losses within 2.4e-7 absolute.  Pinned:
    1 eval target per node, losses 2e-6 absolute."""
    sc = lm_scenario
    _, _, jres, res = lm_grid
    assert np.all(np.isfinite(res.train_loss))
    np.testing.assert_allclose(res.train_loss, np.asarray(jres.train_loss),
                               rtol=0, atol=2e-6)
    for key, t in (("iid_acc", sc["test_iid"]), ("ood_acc", sc["test_ood"])):
        drift = np.abs(getattr(res, key) - np.asarray(getattr(jres, key)))
        assert drift.max() * _masked_targets(t) <= 1 + 1e-3, key


@pytest.mark.parametrize("rows", [1, 3, 6, 8])
def test_sweep_engine_evaluates_in_slices_bit_for_bit(lm_scenario, lm_grid,
                                                      monkeypatch, rows):
    """The engine's evaluation of the grid's final params in slices of 1
    or 3 nodes of an experiment, a whole experiment (6 rows: one of 4
    nodes) or the whole grid (8) a call equals its one-call evaluation
    bit for bit."""
    sc = lm_scenario
    tc, targs, _, one_call = lm_grid
    tests = [_torch(t) for t in targs[5:7]]

    with torch.no_grad():
        want = _port_engine(tc)._evaluate(one_call.params, *tests)
        _set_budget(monkeypatch, sc, "eval", rows)
        got = _port_engine(tc)._evaluate(one_call.params, *tests)
    for a, b in zip(got, want):
        assert a.shape == (2, N) and torch.equal(a, b)


@pytest.mark.parametrize("kind,rows", [("train", 1), ("train", 3),
                                       ("train", 6), ("eval", 6)])
def test_sweep_engine_in_node_slices_matches_one_call(lm_scenario, lm_grid,
                                                      monkeypatch, kind,
                                                      rows):
    """The engine's LocalTrain over the folded ``E·n = 8`` nodes in slices
    of 1 or 3 nodes, or of 6 (one experiment of 4 nodes a call; the
    evaluation then one node of an experiment a call), or its evaluation a whole experiment a call (6 rows: one of 4
    nodes; LocalTrain in one call), against its one-call run
    (``_same_or_close``)."""
    sc = lm_scenario
    tc, targs, _, one_call = lm_grid
    _set_budget(monkeypatch, sc, kind, rows)
    res = _port_engine(tc).run(*targs, batch_size=4)
    hist = {k: getattr(res, k) for k in ("iid_acc", "ood_acc", "train_loss")}
    base = {k: getattr(one_call, k)
            for k in ("iid_acc", "ood_acc", "train_loss")}
    _same_or_close(kind, hist, base, res.params, one_call.params,
                   _targets(sc))


def test_tinymem_grid_through_both_harnesses(monkeypatch):
    """Fig. 4's pair on TinyMem at n = 6, R = 2 through both figure
    harnesses (``run_sweep_cells``: the cell data with the OOD trigger
    mask, the token bank, the engine), GPT-2 narrowed to d 64 on both
    sides and the reference's init carried over.  Measured: every row's
    AUCs within 5.0e-9.  Pinned: 1e-6."""
    import benchmarks.common as jc
    from repro_torch.benchmarks import common as tc

    jcfg, tcfg = _narrow()
    monkeypatch.setattr(jc, "gpt2_tinymem_config", lambda: jcfg)
    monkeypatch.setattr(tc, "gpt2_tinymem_config", lambda: tcfg)
    _, np_tree, _ = _init(jcfg)
    model_fns = tc._model_fns

    def ref_init(ds):
        _, loss, acc, opt = model_fns(ds)
        return (lambda seed: params_from_jax(np_tree, "cpu"), loss, acc,
                opt)

    monkeypatch.setattr(tc, "_model_fns", ref_init)
    monkeypatch.setattr(jc, "tf_init", lambda key, cfg: _init(jcfg)[0])
    sizes = dict(n_train=300, n_test=100, rounds=2, local_epochs=1,
                 batch=4, steps_per_epoch=2, eval_every=1, eval_n=32)
    topo_j, topo_t = (jtopo.barabasi_albert(6, 2, 0),
                      ttopo.barabasi_albert(6, 2, 0))
    jrows = jc.run_sweep_cells(
        [jc.SweepCell("tinymem", topo_j, s) for s in ("unweighted",
                                                      "degree")],
        scale=jc.BenchScale(**sizes))
    trows = tc.run_sweep_cells(
        [tc.SweepCell("tinymem", topo_t, s) for s in ("unweighted",
                                                      "degree")],
        scale=tc.BenchScale(**sizes), device="cpu")
    for a, b in zip(trows, jrows):
        assert (a["strategy"], a["ood_node"]) == (b["strategy"],
                                                  b["ood_node"])
        for k in ("iid_auc", "ood_auc"):
            assert abs(a[k] - b[k]) <= 1e-6, (a["strategy"], k)


def test_lm_grid_probe_runs_the_six_strategies_at_smoke_scale(capsys):
    """``benchmarks.lm_grid --smoke``: README's Fig. 4 TinyMem command cut
    to one step of four nodes runs all six strategies as one grid and
    reports them (memory is read only on the card)."""
    from repro_torch.benchmarks import lm_grid

    out = lm_grid.main(["--smoke"])
    assert out["experiments"] == 6 and out["n_nodes"] == 4
    assert out["peak_memory_gb"] is None and out["slice_calls"] == {}
    assert set(out["ood_auc"]) == {"fl", "weighted", "unweighted", "random",
                                   "degree", "betweenness"}
    assert all(np.isfinite(v) for v in out["ood_auc"].values())
    assert capsys.readouterr().out.startswith("lm_grid {")
