"""The port's ablations (``repro_torch.benchmarks.ablations``) and
``register_strategy`` against the JAX package's on the CPU.

* each ablation's cells carry the settings of the reference's
  ``run_experiment`` calls (dataset, graph, strategy, OOD rank, τ, seed,
  α_l), in its order, and log its CSV rows;
* one smoke cell each of the zoo, the τ sweep and the heterogeneity
  ablation, through the port's engine from the reference's init carried
  over, against the reference's ``run_experiment`` (its legacy loop);
* ``register_strategy`` as the reference's: a plug-in kind reaches
  ``mixing_matrix`` and ``coeffs_stack``; a taken name raises.
"""
import jax
import numpy as np
import pytest
import torch

import benchmarks.ablations as jab
import benchmarks.common as jc
from repro.core import decentralized as jdec
from repro.core import strategies as jstrat
from repro.core import topology as jtopo
from repro.models import paper_models as jm
from repro_torch.benchmarks import ablations as tab
from repro_torch.benchmarks import common as tc
from repro_torch.core import decentralized as tdec
from repro_torch.core import strategies as tstrat
from repro_torch.core import topology as ttopo
from repro_torch.interop import params_from_jax

torch.set_num_threads(2)

SIZES = dict(n_train=600, n_test=120, rounds=3, local_epochs=2, batch=8,
             steps_per_epoch=2, eval_every=1, eval_n=48)


def _fake_row(strategy, tau, seed, alpha_l):
    """A stub summary row that depends on the cell's settings only."""
    x = (7 * seed + len(strategy) + 3 * tau + alpha_l % 7) / 100
    return {"secs": 0.25 + x, "iid_auc": x, "ood_auc": x / 2}


def _reference_calls(monkeypatch, fn, **kw):
    """The reference ablation's ``run_experiment`` calls (its settings)
    and its log lines, with a stub row per call."""
    calls, lines = [], []

    def stub(dataset, topo, strategy, ood_k=1, tau=0.1, seed=0,
             alpha_l=1000.0, **kwargs):
        calls.append(dict(dataset=dataset, adjacency=topo.adjacency.tobytes(),
                          strategy=strategy, ood_k=ood_k, tau=tau, seed=seed,
                          alpha_l=alpha_l))
        return _fake_row(strategy, tau, seed, alpha_l)

    monkeypatch.setattr(jab, "run_experiment", stub)
    fn(log=lines.append, **kw)
    return calls, lines


def _port_calls(monkeypatch, fn, **kw):
    """The same for the port: the cells it hands ``run_sweep_cells`` (with
    the grid's ``alpha_l``) and its log lines, with the same stub rows."""
    calls, lines = [], []

    def stub(cells, alpha_l=1000.0, **kwargs):
        for c in cells:
            calls.append(dict(dataset=c.dataset,
                              adjacency=c.topo.adjacency.tobytes(),
                              strategy=c.strategy, ood_k=c.ood_k, tau=c.tau,
                              seed=c.seed, alpha_l=alpha_l))
        return [_fake_row(c.strategy, c.tau, c.seed, alpha_l) for c in cells]

    monkeypatch.setattr(tab, "run_sweep_cells", stub)
    fn(log=lines.append, device="cpu", **kw)
    return calls, lines


@pytest.mark.parametrize("name", ["run_centrality_zoo", "run_tau_sweep",
                                  "run_heterogeneity"])
def test_ablation_cells_and_rows_equal_the_reference(monkeypatch, name):
    """At two seeds, the port's cells carry the settings of the reference's
    ``run_experiment`` calls and its CSV lines equal the reference's on
    the same rows, line for line.  The zoo and the τ sweep are one grid in
    the reference's order; the heterogeneity ablation runs one grid per
    α_l, so its cells come grouped by α_l, and it logs them back in the
    reference's order."""
    jcalls, jlines = _reference_calls(monkeypatch, getattr(jab, name),
                                      seeds=(0, 1))
    pcalls, plines = _port_calls(monkeypatch, getattr(tab, name),
                                 seeds=(0, 1))
    if name == "run_heterogeneity":
        assert sorted(map(str, pcalls)) == sorted(map(str, jcalls))
        assert [c["alpha_l"] for c in pcalls] == sorted(
            (c["alpha_l"] for c in jcalls), key=tab.ALPHAS.index)
    else:
        assert pcalls == jcalls
    assert plines == jlines


def _carry_reference_init(monkeypatch):
    init = jax.jit(jm.ffn_init)
    model_fns = tc._model_fns

    def ref_init(ds):
        _, loss, acc, opt = model_fns(ds)
        return (lambda seed: params_from_jax(
            jax.tree.map(np.asarray, init(jax.random.key(seed))), "cpu"),
            loss, acc, opt)

    monkeypatch.setattr(tc, "_model_fns", ref_init)


@pytest.mark.parametrize("name,kw,ref_kw", [
    ("run_centrality_zoo", dict(strategies=("eigenvector",)),
     dict(strategy="eigenvector")),
    ("run_tau_sweep", dict(taus=(0.5,)), dict(strategy="degree", tau=0.5)),
    ("run_heterogeneity", dict(alphas=(0.3,), strategies=("degree",)),
     dict(strategy="degree", alpha_l=0.3)),
])
def test_one_smoke_cell_matches_run_experiment(monkeypatch, name, kw,
                                               ref_kw):
    """One cell of each ablation at n = 16, R = 3 through the port's
    engine against the reference's ``run_experiment`` on the same cell,
    the reference's init carried over: IID and OOD AUC within 1e-6
    (measured: at most 1.9e-8; the reference's legacy loop and engine part
    by one f32 ulp, ROADMAP Queue 3), the OOD node equal."""
    strategy = ref_kw.pop("strategy")
    ref = jc.run_experiment("mnist", jtopo.barabasi_albert(16, 2, seed=0),
                            strategy, ood_k=1, seed=0,
                            scale=jc.BenchScale(**SIZES), **ref_kw)
    _carry_reference_init(monkeypatch)
    (row,) = getattr(tab, name)(scale=tc.BenchScale(**SIZES),
                                log=lambda *a: None, device="cpu", **kw)
    assert (row["strategy"], row["ood_node"]) == (strategy, ref["ood_node"])
    for k in ("iid_auc", "ood_auc"):
        assert abs(row[k] - ref[k]) <= 1e-6, (k, row[k], ref[k])


def test_register_strategy_behaves_as_the_reference():
    """A plug-in kind (half self-weight, the rest over the neighbours)
    goes through ``mixing_matrix`` and ``coeffs_stack`` in both packages
    to the same matrices (exact: the float64 host code, the stack cast to
    f32 as the port keeps it); registering a taken name raises
    ``KeyError`` in both, and the registry keeps the first."""

    def half_self(topo, strategy, data_counts=None):
        a = np.asarray(topo.adjacency, np.float64)
        return 0.5 * np.eye(topo.n_nodes) + 0.5 * a / a.sum(1, keepdims=True)

    name = "half_self_plugin"
    jstrat.register_strategy(name, half_self)
    tstrat.register_strategy(name, half_self)
    try:
        for mod in (jstrat, tstrat):
            with pytest.raises(KeyError, match="already registered"):
                mod.register_strategy(name, lambda *a, **k: None)
            with pytest.raises(KeyError, match="already registered"):
                mod.register_strategy("degree", half_self)
            assert mod.STRATEGIES[name] is half_self
        jt, tt = (jtopo.barabasi_albert(9, 2, seed=3),
                  ttopo.barabasi_albert(9, 2, seed=3))
        want = jstrat.mixing_matrix(jt, jstrat.AggregationStrategy(name))
        got = tstrat.mixing_matrix(tt, tstrat.AggregationStrategy(name))
        assert np.array_equal(got, want)
        jstack = np.asarray(jdec.coeffs_stack(
            jt, jstrat.AggregationStrategy(name), 3))
        tstack = np.asarray(tdec.coeffs_stack(
            tt, tstrat.AggregationStrategy(name), 3))
        assert np.array_equal(tstack, jstack.astype(np.float32))
    finally:
        jstrat.STRATEGIES.pop(name, None)
        tstrat.STRATEGIES.pop(name, None)
