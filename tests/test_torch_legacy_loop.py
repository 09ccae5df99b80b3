"""The port's legacy per-round loop against the JAX package's, on the CPU.

``repro_torch.benchmarks.common.run_experiment`` (one cell, Algorithm 1 as
a host loop over ``DecentralizedTrainer``) and
``repro_torch.benchmarks.ablations.run_link_failure(in_scan=False)`` (the
same loop fed each round's matrix of a link-failure coefficient program)
against ``benchmarks.common.run_experiment`` and the reference's
``in_scan=False``, with the reference's init carried over, at the tiny
scale of ``tests/test_sweep_programs.py``.  Then the reference's own
claims on the port: the in-scan link-failure grid equals the legacy loop
on the AUCs exactly; the fused-plane backend (its plain version here)
gives the einsum's rows; the loop equals the engine run of the same cell
(E = 1) for every dataset of ``DATASET_SETUP``.
"""
import jax
import numpy as np
import pytest
import torch

import benchmarks.ablations as jab
import benchmarks.common as jc
import repro.core.propagation as jprop
from repro.core.topology import barabasi_albert as jba
from repro.models import paper_models as jm
from repro_torch.benchmarks import ablations as tab
from repro_torch.benchmarks import common as tc
from repro_torch.benchmarks import sweep as tsweep
from repro_torch.core.topology import barabasi_albert as tba
from repro_torch.interop import params_from_jax
from repro_torch.kernels import gossip_mix as gm

torch.set_num_threads(2)

TINY = dict(n_train=400, n_test=100, rounds=3, local_epochs=1, batch=8,
            steps_per_epoch=2, eval_every=2, eval_n=32)
N = 16
# Measured against the reference (run_experiment on BA(16, 2): unweighted,
# degree, degree with ood_ks (1, 2); the link-failure loop's 4 rows): the
# per-node accuracies 0 eval samples apart, the AUCs 0.0 apart, the
# per-round train losses within 4.8e-7.  Pinned: accuracies and AUCs 1
# eval sample (of 32), losses 2e-6 (the engine tests' loss pin).
ACC_SAMPLES = 1
LOSS_ATOL = 2e-6
# Measured: the loop and the engine's run of the same cell (E = 1,
# unrolled), every dataset, AUCs and final accuracies 0.0 apart.  Pinned
# at 1e-6, the engine tests' accuracy pin.
ENGINE_ATOL = 1e-6
_init = jax.jit(jm.ffn_init)


def _ref_init(seed):
    return params_from_jax(
        jax.tree.map(np.asarray, _init(jax.random.key(seed))), "cpu")


@pytest.fixture
def ref_init(monkeypatch):
    """The port's ``_model_fns`` with the reference's FFN init."""
    model_fns = tc._model_fns

    def fns(ds):
        _, loss, acc, opt = model_fns(ds)
        return _ref_init, loss, acc, opt

    monkeypatch.setattr(tc, "_model_fns", fns)


def _histories(monkeypatch, module):
    """Every history handed to ``module.propagation_summary``, in order."""
    hists = []
    orig = module.propagation_summary

    def keep(hist, *args, **kwargs):
        hists.append(hist)
        return orig(hist, *args, **kwargs)

    monkeypatch.setattr(module, "propagation_summary", keep)
    return hists


def _hold(ha, hb, n_eval):
    """Two histories: the same eval rounds, per-node accuracies within
    ``ACC_SAMPLES`` eval samples, train losses within ``LOSS_ATOL``.
    Returns the highest accuracy seen."""
    assert [m.round for m in ha] == [m.round for m in hb]
    seen = 0.0
    for a, b in zip(ha, hb):
        for k in ("iid_acc", "ood_acc"):
            x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
            assert np.abs(x - y).max() * n_eval <= ACC_SAMPLES + 1e-6, k
            seen = max(seen, float(y.max()))
        np.testing.assert_allclose(np.asarray(a.train_loss), b.train_loss,
                                   rtol=0, atol=LOSS_ATOL)
    return seen


@pytest.mark.parametrize("strategy,kw", [
    ("unweighted", {}), ("degree", {}), ("degree", {"ood_ks": (1, 2)})],
    ids=["unweighted", "degree", "degree-ood_ks12"])
def test_run_experiment_matches_the_reference(monkeypatch, ref_init,
                                              strategy, kw):
    """One cell on MNIST over BA(16, 2) through both loops: the same row
    keys and labels, AUCs and each eval round's per-node accuracies within
    ``ACC_SAMPLES``, losses within ``LOSS_ATOL``."""
    jh, th = _histories(monkeypatch, jc), _histories(monkeypatch, tc)
    a = jc.run_experiment("mnist", jba(N, 2, seed=0), strategy,
                          scale=jc.BenchScale(**TINY), **kw)
    b = tc.run_experiment("mnist", tba(N, 2, seed=0), strategy,
                          scale=tc.BenchScale(**TINY), device="cpu", **kw)
    assert set(a) == set(b)
    for k in ("dataset", "topology", "strategy", "ood_k", "ood_node",
              "seed", "ood_sources", "ood_ks"):
        assert a.get(k) == b.get(k), k
    for k in ("iid_auc", "ood_auc", "final_ood_acc_mean"):
        assert abs(a[k] - b[k]) * TINY["eval_n"] <= ACC_SAMPLES + 1e-6, k
    assert _hold(jh[0], th[0], TINY["eval_n"]) > 0


LINKFAIL = dict(p_fails=(0.0, 0.5), strategies=("unweighted", "degree"),
                seeds=(0,), n_nodes=4, reactive=True, log=lambda *_: None)


def _port_init(ds, seed):
    return _ref_init(seed)


def test_link_failure_legacy_loop_matches_the_reference(monkeypatch):
    """``run_link_failure(in_scan=False)``, 4 rows (unweighted and degree
    at p_fail 0 and 0.5, reactive, n = 4): the reference's keys and
    labels, AUCs and per-node accuracies within ``ACC_SAMPLES``, losses
    within ``LOSS_ATOL``."""
    jh = _histories(monkeypatch, jprop)
    th = _histories(monkeypatch, tab)
    ref = jab.run_link_failure(in_scan=False, scale=jc.BenchScale(**TINY),
                               **LINKFAIL)
    port = tab.run_link_failure(in_scan=False, scale=tc.BenchScale(**TINY),
                                device="cpu", init_fn=_port_init, **LINKFAIL)
    assert len(ref) == len(port) == len(jh) == len(th) == 4
    seen = 0.0
    for a, b, ha, hb in zip(ref, port, jh, th):
        assert set(a) == set(b)
        for k in ("strategy", "p_fail", "seed", "reactive", "ood_sources"):
            assert a[k] == b[k], k
        for k in ("iid_auc", "ood_auc"):
            assert abs(a[k] - b[k]) * TINY["eval_n"] <= ACC_SAMPLES + 1e-6
        seen = max(seen, _hold(ha, hb, TINY["eval_n"]))
    assert seen > 0   # the comparison sees a model that learned


# the tiny scale, and one where the OOD knowledge reaches the OOD test set
# (AUCs above 0), at n = 8
LONGER = dict(n_train=800, n_test=100, rounds=6, local_epochs=2, batch=8,
              steps_per_epoch=4, eval_every=1, eval_n=32)


@pytest.mark.parametrize("sizes,n", [(TINY, 4), (LONGER, 8)],
                         ids=["tiny", "longer"])
def test_link_failure_in_scan_equals_the_legacy_loop(sizes, n):
    """The reference's claim (``tests/test_sweep_programs.py``) on the
    port: the in-scan programs give the legacy loop's AUCs exactly."""
    kw = dict(LINKFAIL, n_nodes=n, scale=tc.BenchScale(**sizes),
              device="cpu")
    in_scan = tab.run_link_failure(in_scan=True, **kw)
    legacy = tab.run_link_failure(in_scan=False, **kw)
    assert len(in_scan) == len(legacy) == 4
    for a, b in zip(in_scan, legacy):
        assert (a["strategy"], a["p_fail"]) == (b["strategy"], b["p_fail"])
        assert a["iid_auc"] == b["iid_auc"]
        assert a["ood_auc"] == b["ood_auc"]
    if sizes is LONGER:
        assert max(r["ood_auc"] for r in legacy) > 0


def test_pallas_and_einsum_give_the_same_rows():
    """``mix_impl="pallas"`` on CPU tensors takes ``gossip_plane``'s plain
    version (one call a round, no launch) and gives the einsum's rows,
    every field but the wall time."""
    sc = tc.BenchScale(**TINY)
    topo = tba(N, 2, seed=0)
    calls, launches = gm.gossip_plane.calls, gm.gossip_plane.launches
    a = tc.run_experiment("mnist", topo, "degree", scale=sc, device="cpu")
    assert gm.gossip_plane.calls == calls
    b = tc.run_experiment("mnist", topo, "degree", scale=sc, device="cpu",
                          mix_impl="pallas")
    assert gm.gossip_plane.calls == calls + TINY["rounds"]
    assert gm.gossip_plane.launches == launches
    assert set(a) == set(b)
    for k in set(a) - {"secs"}:
        assert a[k] == b[k], k


@pytest.mark.parametrize("dataset", sorted(tc.DATASET_SETUP))
def test_loop_equals_the_engine_on_every_dataset(dataset):
    """``run_experiment`` takes every dataset of ``DATASET_SETUP`` (the
    FFN, VGG-16, GPT-2 on TinyMem with its OOD mask) and gives the engine's
    row for the same cell (E = 1, unrolled) within ``ENGINE_ATOL``."""
    sc = tc.BenchScale(n_train=64, n_test=32, rounds=1, local_epochs=1,
                       batch=2, steps_per_epoch=1, eval_every=1, eval_n=8)
    topo = tba(4, 2, seed=0)
    a = tc.run_experiment(dataset, topo, "degree", scale=sc, device="cpu")
    b = tc.run_sweep_cells([tc.SweepCell(dataset, topo, "degree")],
                           scale=sc, device="cpu", unroll_eval=True)[0]
    for k in ("iid_auc", "ood_auc", "final_ood_acc_mean"):
        assert np.isfinite(a[k]) and abs(a[k] - b[k]) <= ENGINE_ATOL, k
    assert a["final_ood_acc_by_hop"].keys() == b["final_ood_acc_by_hop"].keys()


def test_legacy_baseline_is_the_loop(monkeypatch):
    """The sweep CLI's baseline runs one ``run_experiment`` a cell with the
    cell's dataset, graph, strategy, OOD ranks, τ and seed and the grid's
    backend and device."""
    seen = []

    def fake(dataset, topo, strategy, **kw):
        seen.append((dataset, topo.name, strategy, kw))
        return {"secs": 0.0, "ood_auc": 0.5}

    monkeypatch.setattr(tsweep, "run_experiment", fake)
    cells = tsweep.PRESETS["multisource"].build(("mnist",), (0,), 8)
    rows = tsweep.run_legacy_baseline(cells, tsweep.SMOKE,
                                      log=lambda *a: None, device="cpu",
                                      mix_impl="edges")
    assert len(rows) == len(seen) == len(cells)
    for c, (ds, topo, strat, kw) in zip(cells, seen):
        assert (ds, topo, strat) == (c.dataset, c.topo.name, c.strategy)
        assert kw == dict(ood_k=c.ood_k, ood_ks=c.ood_ks, tau=c.tau,
                          seed=c.seed, scale=tsweep.SMOKE, device="cpu",
                          mix_impl="edges")


def test_default_device_raises_without_a_gpu(monkeypatch):
    """``device=None`` is the card: without one, the loop and the legacy
    link-failure path raise instead of falling back to the CPU; the legacy
    path refuses grid keywords it cannot honour."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = tc.BenchScale(**TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.run_experiment("mnist", tba(4, 2, seed=0), "degree", scale=sc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tab.run_link_failure(in_scan=False, scale=sc, **LINKFAIL)
    with pytest.raises(TypeError, match="data_fn"):
        tab.run_link_failure(in_scan=False, scale=sc, device="cpu",
                             data_fn=None, **LINKFAIL)
