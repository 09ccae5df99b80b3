"""The port's sweep engine (``repro_torch.core.sweep``) against the JAX
package's on the CPU.

The grid is the golden suite's (``tests/regen_goldens.py``: four
experiments at n = 6, R = 6, ring and star, one and two OOD sources, the
FFN), with the same inputs on both sides: the reference's init carried
over, the bank and schedule from the port's own copy of the data layer.

* stack coefficients with analytics, program coefficients, partial
  participation, and faults (``signflip``, ``noise``, ``nan`` with the
  nonfinite guard) against the reference engine, to tolerances measured
  here and stated beside each pin;
* scanned == chunked == unrolled, and a run killed after a chunk and
  resumed == the uninterrupted run, bit for bit (params and history);
* ``tests/goldens/sweep_analytics.json`` reproduced to its ``TOL = 1e-5``;
* the figure drivers' ``cells()`` equal to the reference's, and a tiny
  Fig. 4 ``run()`` against the reference's rows.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import tests.regen_goldens as rg
from repro.core import analytics as jan
from repro.core import coeffs as jco
from repro.core import dynamic as jdyn
from repro.core.decentralized import DecentralizedConfig as JConfig
from repro.core.sweep import SweepEngine as JEngine
from repro.models import paper_models as jm
from repro.training import optimizer as jopt
from repro_torch import tree as tree_util
from repro_torch.core import dynamic as tdyn
from repro_torch.core.analytics import AnalyticsSpec
from repro_torch.core.coeffs import ProgramCoeffs, program_for, stack_states
from repro_torch.core.decentralized import DecentralizedConfig
from repro_torch.core.strategies import AggregationStrategy
from repro_torch.core.sweep import CRASH_ENV, SweepEngine
from repro_torch.interop import params_from_jax
from repro_torch.models import paper_models as tm
from repro_torch.training.optimizer import sgd, skip_nonfinite_updates

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = rg.BATCH
# Measured against the reference engine on this grid (the stack,
# program and participation runs): per-round train loss within 4.8e-7
# absolute, accuracies within 6e-8 (1/48 steps, so a flipped eval sample
# would show as 2.1e-2), streaming AUCs within 1.5e-8.  The fault runs
# have their own pins (FAULT_CASES).
# Pinned: loss 2e-6, accuracies and AUCs 1e-6, arrival rounds exact.
LOSS_ATOL = 2e-6
ACC_ATOL = 1e-6


def _np(t):
    return {k: np.asarray(v) for k, v in t.items()}


@pytest.fixture(scope="module")
def grid():
    """The golden grid's reference engine and inputs, and the port's."""
    jengine, args = rg.build_engine_inputs()
    params0, coeffs, bank, indices, data_idx, ti, to = args
    p0 = params_from_jax(jax.tree.map(np.asarray, params0), "cpu")
    targs = (p0, coeffs, bank, indices, data_idx, _np(ti), _np(to))
    return jengine, args, targs


def _port_engine(opt=None, **cfg):
    return SweepEngine(opt or sgd(1e-2), tm.classifier_loss(tm.ffn_apply),
                       tm.classifier_accuracy(tm.ffn_apply),
                       DecentralizedConfig(rounds=rg.ROUNDS, local_epochs=2,
                                           eval_every=rg.EVAL_EVERY, **cfg),
                       device="cpu")


def _assert_close(res, jres, loss_atol=LOSS_ATOL, acc_atol=ACC_ATOL):
    np.testing.assert_allclose(res.train_loss, jres.train_loss, rtol=0,
                               atol=loss_atol)
    for k in ("iid_acc", "ood_acc"):
        np.testing.assert_allclose(getattr(res, k), getattr(jres, k),
                                   rtol=0, atol=acc_atol, err_msg=k)


def _assert_same(a, b):
    """Two port results bit for bit: history, params, every digest."""
    for k in ("train_loss", "iid_acc", "ood_acc"):
        assert np.array_equal(getattr(a, k), getattr(b, k),
                              equal_nan=True), k
    for x, y in zip(tree_util.leaves(a.params), tree_util.leaves(b.params)):
        assert torch.equal(x, y) or bool(
            (torch.isnan(x) == torch.isnan(y)).all()
            and torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)))
    for name in ("analytics", "participation", "fault"):
        da, db = getattr(a, name), getattr(b, name)
        assert (da is None) == (db is None), name
        for k in (da or {}):
            assert np.array_equal(da[k], db[k], equal_nan=True), (name, k)


# ----------------------------------------------------------------------
# against the reference engine
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_run(grid):
    """The reference engine's run of the grid (stack coefficients,
    analytics at the golden threshold)."""
    jengine, args, _ = grid
    return jengine.run(*args, batch_size=BATCH,
                       analytics=jan.AnalyticsSpec(rg.THRESHOLD))


def test_stack_coefficients_with_analytics_match_the_reference(
        grid, reference_run):
    _, _, targs = grid
    jres = reference_run
    res = _port_engine().run(*targs, batch_size=BATCH,
                             analytics=AnalyticsSpec(rg.THRESHOLD))
    assert res.train_loss.shape == (4, rg.ROUNDS, rg.N)
    _assert_close(res, jres)
    for k, v in jres.analytics.items():
        if np.asarray(v).dtype.kind == "i":
            assert np.array_equal(res.analytics[k], v), k
        else:
            np.testing.assert_allclose(res.analytics[k], v, rtol=0,
                                       atol=1e-6 if k != "gap_pct" else 1e-4,
                                       err_msg=k)
    for e in range(4):
        h, jh = res.history(e), jres.history(e)
        assert [m.round for m in h] == [m.round for m in jh]
        p = res.experiment_params(e)
        assert tree_util.leaves(p)[0].shape[0] == rg.N


def _programs(counts):
    """The golden grid's cells as coefficient programs (``random``
    resamples each round), one state an experiment."""
    states, program = [], None
    for e, (_, topo, strat, _) in enumerate(rg.scenarios()):
        program, state = program_for(
            _port_topo(topo), AggregationStrategy(strat, tau=0.1, seed=0),
            data_counts=counts[e])
        states.append(state)
    return ProgramCoeffs(program, stack_states(states))


def _port_topo(jtopo):
    from repro_torch.core.topology import from_adjacency

    return from_adjacency(np.asarray(jtopo.adjacency), name=jtopo.name)


def test_program_coefficients_equal_the_stack_and_the_reference(grid):
    """A non-reactive program makes the same matrices as its stack, so
    the run is bit for bit the stack's; against the reference engine's
    program run to the pinned tolerances."""
    jengine, args, targs = grid
    counts = [np.asarray(s) for s in _data_counts()]
    prog = _programs(counts)
    port = _port_engine()
    res_p = port.run(targs[0], prog, *targs[2:], batch_size=BATCH)
    stack = np.stack([prog.program.materialize(prog.state(e), rg.ROUNDS)
                      for e in range(4)])
    # the port's f32 program against the reference's matrices: the
    # softmax's exp may round differently (measured: at most 1.2e-7)
    np.testing.assert_allclose(stack, np.asarray(targs[1]), rtol=0,
                               atol=1e-6)
    res_s = port.run(targs[0], stack, *targs[2:], batch_size=BATCH)
    _assert_same(res_p, res_s)
    jstates = jco.stack_states([
        jco.program_for(topo, jco.AggregationStrategy(strat, tau=0.1,
                                                       seed=0),
                        data_counts=counts[e])[1]
        for e, (_, topo, strat, _) in enumerate(rg.scenarios())])
    jprog = jco.program_for(rg.scenarios()[0][1],
                            jco.AggregationStrategy("unweighted"))[0]
    jres = jengine.run(args[0], jco.ProgramCoeffs(jprog, jstates),
                       *args[2:], batch_size=BATCH)
    _assert_close(res_p, jres)


def _data_counts():
    """Each experiment's per-node sample counts (the ``weighted`` kind's
    and ``regen_goldens.build_engine_inputs``' ``data_counts``)."""
    from repro_torch.data.distribution import node_datasets
    from repro_torch.data.pipeline import NodeBatcher
    from repro_torch.data.synthetic import make_dataset

    train = make_dataset("mnist", 360, seed=0)
    out = []
    for _, _, _, srcs in rg.scenarios():
        parts = node_datasets(train, rg.N, ood_node=srcs, q=0.10, seed=0)
        out.append(NodeBatcher(parts, batch_size=BATCH, steps_per_epoch=2,
                               seed=0, local_epochs=2).data_counts())
    return out


@pytest.mark.parametrize("stale", [True, False])
def test_partial_participation_matches_the_reference(grid, stale):
    jengine, args, targs = grid
    rates = np.array([1.0, 0.7, 0.5, 0.3], np.float32)
    jres = jengine.run(*args, batch_size=BATCH,
                       participation=jdyn.ParticipationSpec(
                           stale_mixing=stale, seed=3),
                       participation_rates=rates,
                       analytics=jan.AnalyticsSpec(0.5))
    res = _port_engine().run(*targs, batch_size=BATCH,
                             participation=tdyn.ParticipationSpec(
                                 stale_mixing=stale, seed=3),
                             participation_rates=rates,
                             analytics=AnalyticsSpec(0.5))
    _assert_close(res, jres)
    for k, v in jres.participation.items():
        assert np.array_equal(res.participation[k], np.asarray(v)), k


def _support():
    sup = np.eye(rg.N)
    for _, topo, _, _ in rg.scenarios():
        sup = np.maximum(sup, np.asarray(topo.adjacency))
    return sup


# Fault runs, measured against the reference engine (rates 0, 0.2, 0.3,
# 0.5; seed 5; noise_scale 0.5): the fault and quarantine counters equal
# exactly; the rate-0 experiment within 4.8e-7 of train loss.  Where the
# rule contains the faults (sign flips under the mean, noise under the
# median) the faulty experiments stay within 6.6e-7 relative loss and
# 3e-6 eval samples.  Where it does not — the trimmed mean against 3x
# sign flips at rate 0.3 (two faulty rows in a neighbourhood), noise with
# the quarantine screen, whose first round seeds the norm EMA with noisy
# rows — the losses blow up (to 12.3 and 195.9) and amplify the last-ulp
# differences of the noise draw's erf_inv and of the trimmed sums' order:
# 0.135 and 0.040 relative loss, 1 and 4 eval samples of 48.  Pinned per
# case from those: (relative loss, eval samples).
FAULT_CASES = {
    ("signflip", "mean", False): (2e-6, 1e-3),
    ("signflip", "trimmed", False): (0.15, 1 + 1e-3),
    ("noise", "mean", True): (0.05, 4 + 1e-3),
    ("noise", "median", False): (2e-6, 1e-3),
}


@pytest.mark.parametrize("mode,robust,quarantine", list(FAULT_CASES))
def test_faults_match_the_reference(grid, mode, robust, quarantine):
    _, args, targs = grid
    rates = np.array([0.0, 0.2, 0.3, 0.5], np.float32)
    kw = dict(robust=robust)
    sup = _support() if robust != "mean" else None
    jengine = JEngine(jopt.sgd(1e-2), jm.classifier_loss(jm.ffn_apply),
                      jm.classifier_accuracy(jm.ffn_apply),
                      JConfig(rounds=rg.ROUNDS, local_epochs=2,
                              eval_every=rg.EVAL_EVERY, **kw),
                      mix_support=sup)
    jres = jengine.run(*args, batch_size=BATCH,
                       fault=jdyn.FaultSpec(mode=mode, seed=5,
                                            noise_scale=0.5,
                                            quarantine=quarantine),
                       fault_rates=rates)
    port = SweepEngine(sgd(1e-2), tm.classifier_loss(tm.ffn_apply),
                       tm.classifier_accuracy(tm.ffn_apply),
                       DecentralizedConfig(rounds=rg.ROUNDS, local_epochs=2,
                                           eval_every=rg.EVAL_EVERY, **kw),
                       mix_support=sup, device="cpu")
    res = port.run(*targs, batch_size=BATCH,
                   fault=tdyn.FaultSpec(mode=mode, seed=5, noise_scale=0.5,
                                        quarantine=quarantine),
                   fault_rates=rates)
    for k, v in jres.fault.items():
        assert np.array_equal(res.fault[k], np.asarray(v)), k
    assert res.fault["fault_rounds"][0].sum() == 0   # rate 0: no fault
    np.testing.assert_allclose(res.train_loss[0], jres.train_loss[0],
                               rtol=0, atol=LOSS_ATOL)
    rel, samples = FAULT_CASES[(mode, robust, quarantine)]
    np.testing.assert_allclose(res.train_loss, jres.train_loss, rtol=rel,
                               atol=LOSS_ATOL)
    for k in ("iid_acc", "ood_acc"):
        assert np.abs(getattr(res, k) - getattr(jres, k)).max() * 48 \
            <= samples, k


def test_nan_faults_with_the_nonfinite_guard(grid):
    """NaN faults through the trimmed mean with ``skip_nonfinite_updates``
    on both sides: the same fault and quarantine counts, NaN losses where
    the reference has them, the rest within 2.4e-7 (measured; pinned
    ``LOSS_ATOL``), the skipped steps counted per node, and the rate-0
    experiment bit for bit the port's guarded fault-free run."""
    _, args, targs = grid
    rates = np.array([0.0, 0.2, 0.3, 0.5], np.float32)
    sup = _support()
    jengine = JEngine(jopt.skip_nonfinite_updates(jopt.sgd(1e-2)),
                      jm.classifier_loss(jm.ffn_apply),
                      jm.classifier_accuracy(jm.ffn_apply),
                      JConfig(rounds=rg.ROUNDS, local_epochs=2,
                              eval_every=rg.EVAL_EVERY, robust="trimmed"),
                      mix_support=sup)
    jres = jengine.run(*args, batch_size=BATCH,
                       fault=jdyn.FaultSpec(mode="nan", seed=2),
                       fault_rates=rates)
    port = SweepEngine(skip_nonfinite_updates(sgd(1e-2)),
                       tm.classifier_loss(tm.ffn_apply),
                       tm.classifier_accuracy(tm.ffn_apply),
                       DecentralizedConfig(rounds=rg.ROUNDS, local_epochs=2,
                                           eval_every=rg.EVAL_EVERY,
                                           robust="trimmed"),
                       mix_support=sup, device="cpu")
    res = port.run(*targs, batch_size=BATCH,
                   fault=tdyn.FaultSpec(mode="nan", seed=2),
                   fault_rates=rates)
    for k, v in jres.fault.items():
        assert np.array_equal(res.fault[k], np.asarray(v)), k
    assert np.array_equal(np.isnan(res.train_loss),
                          np.isnan(jres.train_loss))
    np.testing.assert_allclose(res.train_loss, jres.train_loss, rtol=0,
                               atol=LOSS_ATOL)
    skipped = res.opt_state["skipped"]
    assert skipped.shape == (4, rg.N) and int(skipped[0].sum()) == 0
    clean = port.run(*targs, batch_size=BATCH)
    for k in ("train_loss", "iid_acc", "ood_acc"):
        assert np.array_equal(getattr(res, k)[0], getattr(clean, k)[0])


# ----------------------------------------------------------------------
# the modes: one loop, bit for bit
# ----------------------------------------------------------------------
def _full_kwargs():
    return dict(batch_size=BATCH, analytics=AnalyticsSpec(0.5),
                participation=tdyn.ParticipationSpec(seed=1),
                participation_rates=np.array([1.0, 0.8, 0.6, 0.9]),
                fault=tdyn.FaultSpec(mode="noise", quarantine=True, seed=4),
                fault_rates=np.array([0.0, 0.1, 0.2, 0.3]))


@pytest.mark.parametrize("extra", ["plain", "full"])
def test_scanned_chunked_unrolled_are_bit_identical(grid, extra):
    _, _, targs = grid
    kw = _full_kwargs() if extra == "full" else dict(
        batch_size=BATCH, analytics=AnalyticsSpec(0.5))
    port = _port_engine()
    scanned = port.run(*targs, **kw)
    for mode in (dict(chunk_rounds=4), dict(chunk_rounds=1),
                 dict(unroll_eval=True)):
        _assert_same(scanned, port.run(*targs, **mode, **kw))
    no_hist = port.run(*targs, keep_history=False, **kw)
    assert no_hist.train_loss.shape == (4, 0, rg.N)
    assert no_hist.history(0) == []
    for k in scanned.analytics:
        assert np.array_equal(no_hist.analytics[k], scanned.analytics[k])


def test_resume_from_a_checkpoint_equals_the_uninterrupted_run(grid,
                                                               tmp_path):
    """Kill the process after the first checkpoint
    (``REPRO_SWEEP_CRASH_AFTER_CHUNKS``, ``os._exit`` with no cleanup),
    resume in this process: params, every carry and the history equal the
    uninterrupted run bit for bit; so does a resume from any boundary."""
    _, _, targs = grid
    port = _port_engine()
    kw = _full_kwargs()
    want = port.run(*targs, **kw)
    ck = tmp_path / "ck"
    code = (
        "import sys, pickle, torch\n"
        "torch.set_num_threads(2)\n"
        f"sys.path[:0] = [{os.path.join(ROOT, 'src')!r}, {ROOT!r}]\n"
        "import tests.test_torch_sweep as t\n"
        "targs, kw = pickle.load(open(sys.argv[1], 'rb'))\n"
        "t._port_engine().run(*targs, chunk_rounds=2, "
        "checkpoint_dir=sys.argv[2], **kw)\n")
    import pickle
    blob = tmp_path / "args.pkl"
    with open(blob, "wb") as f:
        pickle.dump((targs, kw), f)
    env = dict(os.environ, **{CRASH_ENV: "1"})
    r = subprocess.run([sys.executable, "-c", code, str(blob), str(ck)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 17, r.stderr[-2000:]
    assert sorted(os.listdir(ck)) == ["ckpt_00000002.npz"]
    got = port.run(*targs, chunk_rounds=2, checkpoint_dir=str(ck),
                   resume=True, **kw)
    _assert_same(want, got)
    # every boundary: rounds 2 and 4 on disk, resume from round 2
    ck2 = tmp_path / "ck2"
    port.run(*targs, chunk_rounds=2, checkpoint_dir=str(ck2), **kw)
    assert sorted(os.listdir(ck2)) == ["ckpt_00000002.npz",
                                       "ckpt_00000004.npz"]
    os.remove(ck2 / "ckpt_00000004.npz")
    _assert_same(want, port.run(*targs, chunk_rounds=2,
                                checkpoint_dir=str(ck2), resume=True, **kw))


def test_engine_refuses_what_it_cannot_run(grid):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_sweep_mesh

    _, _, targs = grid
    port = _port_engine()
    init_distributed("cpu")   # a world of 1
    try:
        with pytest.raises(ValueError, match="--nproc-per-node 2"):
            make_sweep_mesh(2)   # more ranks than the world
        with pytest.raises(ValueError, match="scanned-mode"):
            port.run(*targs, batch_size=BATCH, mesh=make_sweep_mesh(),
                     unroll_eval=True)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="analytics"):
        port.run(*targs, batch_size=BATCH, keep_history=False)
    with pytest.raises(ValueError, match="chunk_rounds"):
        port.run(*targs, batch_size=BATCH, checkpoint_dir="x")
    with pytest.raises(ValueError, match="ParticipationSpec"):
        port.run(*targs, batch_size=BATCH, participation_rates=0.5)
    ring_only = np.maximum(np.eye(rg.N), _port_topo(
        rg.scenarios()[0][1]).adjacency)
    edges = SweepEngine(sgd(1e-2), tm.classifier_loss(tm.ffn_apply),
                        tm.classifier_accuracy(tm.ffn_apply),
                        DecentralizedConfig(rounds=rg.ROUNDS,
                                            mix_impl="edges"),
                        mix_support=ring_only, device="cpu")
    with pytest.raises(ValueError, match="outside the mix_support"):
        edges.run(*targs, batch_size=BATCH)


# ----------------------------------------------------------------------
# the golden file and the figure drivers
# ----------------------------------------------------------------------
def _golden_payload(analytics, adjacency_of):
    """The golden file's per-scenario numbers from an engine's finalized
    analytics."""
    out = {}
    for e, (name, topo, _, srcs) in enumerate(rg.scenarios()):
        stream = {k: np.asarray(v[e]) for k, v in analytics.items()}
        out[name] = {
            "hops_from_sources": [int(h) for h in adjacency_of(topo, srcs)],
            "iid_auc": stream["iid_auc"], "ood_auc": stream["ood_auc"],
            "ood_arrival": [int(v) for v in stream["ood_arrival"]],
            "final_ood_acc_mean": float(stream["final_ood_acc"].mean())}
    return out


def test_engine_reproduces_the_sweep_analytics_golden(grid, reference_run):
    """``tests/goldens/sweep_analytics.json`` to its ``TOL`` (1e-5;
    arrival rounds and hop fields exact), wherever the reference engine
    reproduces it itself, as in the runs that pass
    ``test_golden.py::test_golden_values_match``.  The file's training
    numbers depend on the machine the reference runs on: on a machine
    where the reference's own run misses them (ROADMAP Queue 3: up to
    0.068 of AUC on some machines), the port is held to that
    live reference run instead, at the same tolerance."""
    _, _, targs = grid
    from repro_torch.core.propagation import hops_from

    with open(rg.GOLDEN_PATH) as f:
        golden = json.load(f)["scenarios"]
    res = _port_engine().run(*targs, batch_size=BATCH,
                             analytics=AnalyticsSpec(rg.THRESHOLD))
    got = _golden_payload(res.analytics, lambda t, s: hops_from(
        t.adjacency, s))
    ref = _golden_payload(reference_run.analytics, lambda t, s: hops_from(
        t.adjacency, s))

    def holds(a, b):
        return all(
            a[k]["hops_from_sources"] == b[k]["hops_from_sources"]
            and a[k]["ood_arrival"] == b[k]["ood_arrival"]
            and np.allclose(a[k]["iid_auc"], b[k]["iid_auc"], rtol=0,
                            atol=rg.TOL)
            and np.allclose(a[k]["ood_auc"], b[k]["ood_auc"], rtol=0,
                            atol=rg.TOL)
            and abs(a[k]["final_ood_acc_mean"]
                    - b[k]["final_ood_acc_mean"]) <= rg.TOL
            for k in b)

    target = golden if holds(ref, golden) else ref
    assert holds(got, target)


def _cell_key(c):
    return (c.dataset, c.strategy, c.ood_k, c.tau, c.seed, c.name, c.sweep,
            c.p_fail, c.reactive, c.ood_ks, c.participation, c.fault_rate,
            c.robust, c.topo.name, c.topo.adjacency.tobytes(),
            c.ood_nodes())


@pytest.mark.parametrize("fig,fns", [
    ("fig2_iid_vs_ood", ("cells",)), ("fig4_strategies", ("cells",)),
    ("fig5_location", ("cells",)),
    ("fig6_topology", ("degree_cells", "modularity_cells",
                       "nodecount_cells")),
    ("common", ("linkfail_cells", "multisource_cells", "edges_cells",
                "participation_cells", "byzantine_cells"))])
def test_figure_cells_equal_the_reference(fig, fns):
    import importlib

    ref = importlib.import_module(f"benchmarks.{fig}")
    port = importlib.import_module(f"repro_torch.benchmarks.{fig}")
    for fn in fns:
        a, b = getattr(port, fn)(), getattr(ref, fn)()
        assert [_cell_key(c) for c in a] == [_cell_key(c) for c in b], fn
    if fig == "common":
        cells = port.byzantine_cells()
        assert port.group_cells(cells) == ref.group_cells(
            ref.byzantine_cells())


def test_fig4_tiny_run_matches_the_reference_rows(monkeypatch):
    """Fig. 4's six strategies at n = 8, R = 3 through both harnesses,
    the reference's init carried over: every row's keys equal and its
    AUCs within 1e-6 (measured: 1.4e-9), the verdict line equal."""
    import benchmarks.common as jc
    import benchmarks.fig4_strategies as jf4
    from repro_torch.benchmarks import common as tc
    from repro_torch.benchmarks import fig4_strategies as tf4

    sizes = dict(n_train=600, n_test=120, rounds=3, local_epochs=2, batch=8,
                 steps_per_epoch=2, eval_every=1, eval_n=48)
    jrows = jf4.run(n_nodes=8, scale=jc.BenchScale(**sizes),
                    log=lambda *a: None)
    model_fns = tc._model_fns
    init = jax.jit(jm.ffn_init)

    def ref_init(ds):
        _, loss, acc, opt = model_fns(ds)
        return (lambda seed: params_from_jax(
            jax.tree.map(np.asarray, init(jax.random.key(seed))), "cpu"),
            loss, acc, opt)

    monkeypatch.setattr(tc, "_model_fns", ref_init)
    trows = tf4.run(n_nodes=8, scale=tc.BenchScale(**sizes),
                    log=lambda *a: None, device="cpu")
    for a, b in zip(trows, jrows):
        assert set(a) == set(b)
        assert (a["strategy"], a["ood_node"]) == (b["strategy"], b["ood_node"])
        for k in ("iid_auc", "ood_auc"):
            assert abs(a[k] - b[k]) <= 1e-6, (a["strategy"], k)
        assert a["analytics"]["stream_vs_host_max_dev"] < 1e-6
    assert tf4.verdict(trows) == jf4.verdict(jrows)


def test_tinymem_and_the_legacy_loop_raise():
    """TinyMem trains GPT-2 cut to one layer with Adam 1e-3 (Table 1;
    its parity is ``tests/test_torch_lm.py``'s).  The legacy link-failure
    loop (``run_link_failure(in_scan=False)``) no longer raises: it
    returns the reference's rows (keys, labels and AUCs; measured 0.0
    apart, pinned at 1e-6; ``tests/test_torch_legacy_loop.py`` holds its
    histories)."""
    import benchmarks.ablations as jab
    import benchmarks.common as jc

    from repro_torch.benchmarks import ablations, common

    init, loss, acc, opt = common._model_fns("tinymem")
    assert callable(loss) and callable(acc.working_bytes)
    assert common.DATASET_SETUP["tinymem"] == dict(model="gpt2",
                                                   opt=("adam", 1e-3))
    assert dataclasses.asdict(common.FULL)["rounds"] == 40
    sizes = dict(n_train=200, n_test=50, rounds=2, local_epochs=1, batch=8,
                 steps_per_epoch=2, eval_every=1, eval_n=32)
    kw = dict(p_fails=(0.5,), strategies=("degree",), n_nodes=4,
              log=lambda *a: None)
    init = jax.jit(jm.ffn_init)
    want = jab.run_link_failure(in_scan=False,
                                scale=jc.BenchScale(**sizes), **kw)
    got = ablations.run_link_failure(
        in_scan=False, scale=common.BenchScale(**sizes), device="cpu",
        init_fn=lambda ds, seed: params_from_jax(
            jax.tree.map(np.asarray, init(jax.random.key(seed))), "cpu"),
        **kw)
    assert len(got) == len(want) == 1
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in ("strategy", "p_fail", "seed", "reactive", "ood_sources"):
            assert a[k] == b[k], k
        for k in ("iid_auc", "ood_auc", "final_ood_acc_mean"):
            assert abs(a[k] - b[k]) <= 1e-6, k
