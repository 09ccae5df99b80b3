"""Paper Fig. 5 — the impact of the OOD data's location (port of
``benchmarks/fig5_location.py``).

Claim: moving the OOD data to lower-degree nodes hurts its propagation
under the topology-aware strategies.  A placement only changes the bank
row an experiment reads, so the strategy × placement grid is one program.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.benchmarks.common import (
    QUICK,
    SweepCell,
    csv_row,
    run_sweep_cells,
)
from repro_torch.core.topology import barabasi_albert


def cells(datasets=("mnist",), n_nodes=16, ba_p=2, seeds=(0,),
          strategies=("degree", "betweenness"),
          ood_ks=(1, 2, 3, 4)) -> List[SweepCell]:
    return [
        SweepCell(ds, barabasi_albert(n_nodes, ba_p, seed=seed), strat,
                  ood_k=k, seed=seed, name=f"fig5/{ds}/{strat}/ood_k{k}")
        for ds in datasets
        for seed in seeds
        for strat in strategies
        for k in ood_ks
    ]


def run(datasets=("mnist",), n_nodes=16, ba_p=2, seeds=(0,),
        strategies=("degree", "betweenness"), ood_ks=(1, 2, 3, 4),
        scale=QUICK, log=print, device=None) -> List[dict]:
    grid = cells(datasets, n_nodes, ba_p, seeds, strategies, ood_ks)
    rows = run_sweep_cells(grid, scale=scale, device=device)
    for cell, r in zip(grid, rows):
        log(csv_row(cell.label, r["secs"], f"ood_auc={r['ood_auc']:.3f}"))
    return rows


def verdict(rows) -> str:
    """OOD AUC non-increasing in the placement rank k (a correlation per
    strategy cell), with the streaming arrival rounds by rank beside it."""
    by_strat, arrivals = {}, {}
    for r in rows:
        by_strat.setdefault((r["dataset"], r["strategy"], r["seed"]), {})[
            r["ood_k"]] = r["ood_auc"]
        arr = r.get("analytics", {}).get("ood_arrival_mean")
        if arr is not None:
            arrivals.setdefault(r["ood_k"], []).append(arr)
    trends = []
    for kmap in by_strat.values():
        ks = sorted(kmap)
        aucs = [kmap[k] for k in ks]
        corr = np.corrcoef(ks, aucs)[0, 1] if len(ks) > 2 else (
            -1.0 if aucs[0] >= aucs[-1] else 1.0)
        trends.append(corr)
    neg = sum(1 for t in trends if t < 0.1)
    arrival_txt = ""
    if arrivals:
        arrival_txt = ("; mean arrival round by rank " + ", ".join(
            f"k{k}={np.mean(arrivals[k]):.1f}" for k in sorted(arrivals)))
    return (f"fig5 claim (lower-degree placement ⇒ worse propagation): "
            f"{neg}/{len(trends)} strategy-cells show the negative trend "
            f"(mean corr {np.mean(trends):.2f}){arrival_txt}")


if __name__ == "__main__":
    print(verdict(run()))
