"""Paper Fig. 2 — the IID vs OOD propagation gap (port of
``benchmarks/fig2_iid_vs_ood.py``).

Claim: under every topology-unaware strategy, OOD test AUC stays well
below IID test AUC across BA topologies; the OOD data sit on the
4th-highest-degree node.  One sweep-engine program per dataset
(``common.run_sweep_cells``).
"""
from __future__ import annotations

from typing import List

from repro_torch.benchmarks.common import (
    QUICK,
    SweepCell,
    csv_row,
    run_sweep_cells,
)
from repro_torch.core.topology import barabasi_albert

STRATEGIES = ("fl", "weighted", "unweighted", "random")


def cells(datasets=("mnist",), ba_p=(2,), n_nodes=16,
          seeds=(0,)) -> List[SweepCell]:
    return [
        SweepCell(ds, barabasi_albert(n_nodes, p, seed=seed), strat,
                  ood_k=4, seed=seed, name=f"fig2/{ds}/ba_p{p}/{strat}")
        for ds in datasets
        for p in ba_p
        for seed in seeds
        for strat in STRATEGIES
    ]


def run(datasets=("mnist",), ba_p=(2,), n_nodes=16, seeds=(0,),
        scale=QUICK, log=print, device=None) -> List[dict]:
    grid = cells(datasets, ba_p, n_nodes, seeds)
    rows = run_sweep_cells(grid, scale=scale, device=device)
    for cell, r in zip(grid, rows):
        log(csv_row(
            cell.label, r["secs"],
            f"iid_auc={r['iid_auc']:.3f};ood_auc={r['ood_auc']:.3f};"
            f"gap_pct={r['iid_ood_gap_pct']:.1f}"))
    return rows


def verdict(rows) -> str:
    """Paper claim: OOD AUC < IID AUC for the baselines."""
    ok = sum(1 for r in rows if r["ood_auc"] < r["iid_auc"])
    return (f"fig2 claim (OOD propagates worse than IID under baselines): "
            f"{ok}/{len(rows)} cells consistent")


if __name__ == "__main__":
    print(verdict(run()))
