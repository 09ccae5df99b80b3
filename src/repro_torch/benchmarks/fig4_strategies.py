"""Paper Fig. 4 (+ Fig. 10) — topology-aware vs topology-unaware
aggregation (port of ``benchmarks/fig4_strategies.py``).

Claim: with the OOD data on the HIGHEST-degree node, Degree and
Betweenness (τ = 0.1) beat FL / Weighted / Unweighted / Random on OOD
accuracy AUC without giving up IID accuracy.  All strategies × seeds of a
dataset run as ONE sweep-engine program, the strategies on its batch axis.
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

STRATEGIES = ("fl", "weighted", "unweighted", "random", "degree",
              "betweenness")
AWARE = ("degree", "betweenness")


def cells(datasets=("mnist",), ba_p=(2,), n_nodes=16,
          seeds=(0,)) -> List[SweepCell]:
    return [
        SweepCell(ds, barabasi_albert(n_nodes, p, seed=seed), strat,
                  ood_k=1, seed=seed, name=f"fig4/{ds}/ba_p{p}/{strat}")
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
        log(csv_row(cell.label, r["secs"],
                    f"iid_auc={r['iid_auc']:.3f};ood_auc={r['ood_auc']:.3f}"))
    return rows


def verdict(rows) -> str:
    """Aware-mean OOD AUC against unaware-mean, and the IID no-sacrifice
    check."""
    aware = [r for r in rows if r["strategy"] in AWARE]
    unaware = [r for r in rows if r["strategy"] not in AWARE]
    a_ood = np.mean([r["ood_auc"] for r in aware])
    u_ood = np.mean([r["ood_auc"] for r in unaware])
    a_iid = np.mean([r["iid_auc"] for r in aware])
    u_iid = np.mean([r["iid_auc"] for r in unaware])
    improve = 100 * (a_ood - u_ood) / max(u_ood, 1e-9)
    return (f"fig4 claim (topology-aware > unaware on OOD): "
            f"aware_ood={a_ood:.3f} vs unaware_ood={u_ood:.3f} "
            f"(+{improve:.0f}%); iid {a_iid:.3f} vs {u_iid:.3f} "
            f"({'no sacrifice' if a_iid > u_iid - 0.05 else 'IID SACRIFICED'})"
            )


if __name__ == "__main__":
    print(verdict(run()))
