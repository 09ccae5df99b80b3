"""Beyond-paper ablations (port of ``benchmarks/ablations.py``):

1. **Centrality-metric zoo** — the paper proposes Degree (local) and
   Betweenness (global) and names further metrics as future work (§7);
   eigenvector, PageRank and closeness join them beside the unweighted
   control at the paper's headline setting.
2. **τ sensitivity** — the paper fixes τ = 0.1; the sweep shows the
   sharpness/robustness trade-off (τ → 0: winner-take-all erases the
   source's own knowledge; τ → ∞: unweighted).
3. **Link-failure robustness** — strategies under i.i.d. per-round edge
   dropout, the unstable-network regime the paper motivates but does not
   measure.  By default each cell's coefficient program draws the
   round's edge mask and — reactive — rebuilds the centralities on the
   surviving graph inside the sweep engine's round loop, so no
   ``(E, R, n, n)`` stack is made; ``in_scan=False`` runs the legacy host
   loop on the same programs' matrices, the equivalence baseline.
4. **Label heterogeneity** — the α_l axis of the paper's Fig. 8: does
   topology-aware aggregation survive when every node is skewed?

The reference runs 1, 2 and 4 one ``run_experiment`` (its legacy
per-cell loop) at a time; here each is a grid through the sweep engine
(``run_sweep_cells``), under the reference's cell names and CSV rows: the
zoo and the τ sweep one grid each (per-experiment coefficient stacks),
the heterogeneity ablation one grid per ``alpha_l`` (an argument of the
data split, so of the grid).  ``common.run_experiment`` runs any of
their cells alone through the legacy loop.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.benchmarks.common import (
    QUICK,
    SweepCell,
    cell_data,
    csv_row,
    linkfail_cells,
    run_sweep_cells,
)
from repro_torch.core.coeffs import program_for
from repro_torch.core.decentralized import (
    DecentralizedConfig,
    DecentralizedTrainer,
    stack_params,
)
from repro_torch.core.propagation import propagation_summary
from repro_torch.core.strategies import AggregationStrategy
from repro_torch.core.topology import barabasi_albert
from repro_torch.models.paper_models import (
    classifier_accuracy,
    classifier_loss,
    ffn_apply,
    ffn_init,
)
from repro_torch.training.optimizer import sgd

__all__ = ["CENTRALITIES", "TAUS", "ALPHAS", "centrality_cells", "tau_cells",
           "heterogeneity_cells", "run_centrality_zoo", "run_tau_sweep",
           "run_link_failure", "run_heterogeneity"]

CENTRALITIES = ("unweighted", "degree", "betweenness", "eigenvector",
                "pagerank", "closeness")
TAUS = (0.01, 0.05, 0.1, 0.5, 2.0)
ALPHAS = (1000.0, 1.0, 0.3)


def _log_rows(rows, cells, log):
    for row, cell in zip(rows, cells):
        log(csv_row(cell.name, row["secs"],
                    f"iid_auc={row['iid_auc']:.3f};"
                    f"ood_auc={row['ood_auc']:.3f}"))


def centrality_cells(dataset="mnist", seeds=(0,),
                     strategies=CENTRALITIES) -> List[SweepCell]:
    """Every centrality on a per-seed BA(16, 2), OOD on the hub."""
    return [SweepCell(dataset, barabasi_albert(16, 2, seed=seed), strat,
                      ood_k=1, seed=seed,
                      name=f"ablation/centrality/{strat}",
                      sweep=("centrality", strat))
            for seed in seeds for strat in strategies]


def tau_cells(dataset="mnist", taus=TAUS, seeds=(0,)) -> List[SweepCell]:
    """``degree`` at each τ on a per-seed BA(16, 2), OOD on the hub."""
    return [SweepCell(dataset, barabasi_albert(16, 2, seed=seed), "degree",
                      ood_k=1, tau=tau, seed=seed, name=f"ablation/tau/{tau}",
                      sweep=("tau", tau))
            for seed in seeds for tau in taus]


def heterogeneity_cells(dataset="mnist", alphas=ALPHAS,
                        strategies=("unweighted", "degree"),
                        seeds=(0,)) -> List[SweepCell]:
    """Strategies × α_l on a per-seed BA(16, 2), in the reference's order
    (seed, α_l, strategy); ``sweep`` carries each cell's α_l."""
    return [SweepCell(dataset, barabasi_albert(16, 2, seed=seed), strat,
                      ood_k=1, seed=seed,
                      name=f"ablation/noniid/a{alpha}/{strat}",
                      sweep=("alpha_l", alpha, strat))
            for seed in seeds for alpha in alphas for strat in strategies]


def run_centrality_zoo(dataset="mnist", seeds=(0,), scale=QUICK, log=print,
                       device=None, strategies=CENTRALITIES,
                       **sweep_kwargs) -> List[Dict]:
    """The centrality zoo as one grid.  ``sweep_kwargs`` pass to
    ``run_sweep_cells`` (``mix_impl``, ``data_fn``, ``init_fn``, ...)."""
    cells = centrality_cells(dataset, seeds, strategies)
    rows = run_sweep_cells(cells, scale=scale, device=device, **sweep_kwargs)
    _log_rows(rows, cells, log)
    return rows


def run_tau_sweep(dataset="mnist", taus=TAUS, seeds=(0,), scale=QUICK,
                  log=print, device=None, **sweep_kwargs) -> List[Dict]:
    """``degree`` at every τ as one grid; each row gains ``tau``."""
    cells = tau_cells(dataset, taus, seeds)
    rows = run_sweep_cells(cells, scale=scale, device=device, **sweep_kwargs)
    for row, cell in zip(rows, cells):
        row["tau"] = cell.tau
    _log_rows(rows, cells, log)
    return rows


def run_link_failure(dataset="mnist", p_fails=(0.0, 0.3, 0.6),
                     strategies=("unweighted", "degree"), seeds=(0,),
                     scale=QUICK, log=print, n_nodes=16, reactive=True,
                     in_scan=True, device=None, **sweep_kwargs):
    """Per-round i.i.d. edge dropout on per-seed BA(n_nodes, 2) graphs, the
    OOD data on the hub.

    ``in_scan=True``: the grid through the engine, each round's matrices
    made in its round loop (``coeff_mode="program"``); ``sweep_kwargs``
    pass to ``run_sweep_cells``.  ``in_scan=False``: the legacy host loop,
    a ``DecentralizedTrainer`` a cell (the FFN, SGD 1e-2) whose
    ``coeffs_fn`` hands it round r's matrix of the same program; of the
    grid's keywords it takes ``mix_impl`` (the trainer's backend) and
    ``init_fn(dataset, seed)`` (one node's params), and raises on any
    other."""
    if in_scan:
        cells = linkfail_cells(datasets=(dataset,), seeds=seeds,
                               n_nodes=n_nodes, strategies=strategies,
                               p_fails=p_fails, reactive=reactive,
                               prefix="ablation/linkfail")
        rows = run_sweep_cells(cells, scale=scale, coeff_mode="program",
                               device=device, **sweep_kwargs)
        for row, cell in zip(rows, cells):
            row.update(p_fail=cell.p_fail, reactive=cell.reactive)
            log(csv_row(cell.name, 0, f"iid_auc={row['iid_auc']:.3f};"
                                      f"ood_auc={row['ood_auc']:.3f}"))
        return rows

    mix_impl = sweep_kwargs.pop("mix_impl", "einsum")
    init_fn = sweep_kwargs.pop("init_fn", None)
    if sweep_kwargs:
        raise TypeError(f"run_link_failure(in_scan=False) takes no "
                        f"{sorted(sweep_kwargs)}")
    rows = []
    for seed in seeds:
        topo = barabasi_albert(n_nodes, 2, seed=seed)
        ood_node = topo.kth_highest_degree_node(1)
        nb, tb, ob = cell_data(dataset, n_nodes, seed, (ood_node,), scale,
                               scale.steps_per_epoch)
        for strat in strategies:
            for pf in p_fails:
                sobj = AggregationStrategy(strat, tau=0.1, seed=seed)
                program, state = program_for(
                    topo, sobj, data_counts=nb.data_counts(), p_fail=pf,
                    reactive=reactive)
                coeffs_fn = lambda r, p=program, s=state: p.materialize(
                    s, round_indices=np.array([r]))[0]
                trainer = DecentralizedTrainer(
                    topo, sobj, sgd(1e-2), classifier_loss(ffn_apply),
                    classifier_accuracy(ffn_apply),
                    DecentralizedConfig(rounds=scale.rounds,
                                        local_epochs=scale.local_epochs,
                                        eval_every=scale.eval_every,
                                        mix_impl=mix_impl),
                    data_counts=nb.data_counts(), coeffs_fn=coeffs_fn,
                    device=device)
                one = (init_fn(dataset, seed) if init_fn is not None
                       else ffn_init(torch.Generator().manual_seed(seed)))
                _, hist = trainer.run(stack_params([one] * n_nodes),
                                      nb.round_batches, tb, ob)
                s = propagation_summary(hist, topo.adjacency, ood_node)
                s.update(strategy=strat, p_fail=pf, seed=seed,
                         reactive=reactive)
                log(csv_row(f"ablation/linkfail/{strat}/p{pf}", 0,
                            f"iid_auc={s['iid_auc']:.3f};"
                            f"ood_auc={s['ood_auc']:.3f}"))
                rows.append(s)
    return rows


def run_heterogeneity(dataset="mnist", alphas=ALPHAS,
                      strategies=("unweighted", "degree"), seeds=(0,),
                      scale=QUICK, log=print, device=None,
                      **sweep_kwargs) -> List[Dict]:
    """Non-IID label skew: one grid per α_l (the data split's skew);
    each row gains ``alpha_l``; rows in the reference's order."""
    cells = heterogeneity_cells(dataset, alphas, strategies, seeds)
    rows: List[Dict] = [None] * len(cells)  # type: ignore[list-item]
    for alpha in alphas:
        idxs = [i for i, c in enumerate(cells) if c.sweep[1] == alpha]
        part = run_sweep_cells([cells[i] for i in idxs], scale=scale,
                               alpha_l=alpha, device=device, **sweep_kwargs)
        for i, row in zip(idxs, part):
            row["alpha_l"] = alpha
            rows[i] = row
    _log_rows(rows, cells, log)
    return rows


if __name__ == "__main__":
    import json
    import os

    z = run_centrality_zoo()
    t = run_tau_sweep()
    f = run_link_failure()
    h = run_heterogeneity()
    os.makedirs("artifacts_torch", exist_ok=True)
    json.dump(dict(centrality=z, tau=t, linkfail=f, heterogeneity=h),
              open("artifacts_torch/ablations.json", "w"), indent=1,
              default=float)
