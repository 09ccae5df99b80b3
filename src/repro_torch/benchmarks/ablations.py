"""Beyond-paper ablations: link-failure robustness (port of the in-scan
path of ``benchmarks/ablations.py`` ``run_link_failure``).

Strategies under i.i.d. per-round edge dropout, the unstable-network
regime the paper motivates but does not measure.  Each cell's
coefficient program draws the round's edge mask and — reactive — rebuilds
the centralities on the surviving graph inside the sweep engine's round
loop, so the whole grid is one program and no ``(E, R, n, n)`` stack is
made.  The reference's legacy host loop (``in_scan=False``) and its other
ablations (the centrality zoo, the τ sweep) run through its per-cell
``run_experiment``, which the port does not have.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import (
    QUICK,
    csv_row,
    linkfail_cells,
    run_sweep_cells,
)


def run_link_failure(dataset="mnist", p_fails=(0.0, 0.3, 0.6),
                     strategies=("unweighted", "degree"), seeds=(0,),
                     scale=QUICK, log=print, n_nodes=16, reactive=True,
                     in_scan=True, device=None, **sweep_kwargs):
    """Per-round i.i.d. edge dropout, in the engine's loop
    (``coeff_mode="program"``).  ``sweep_kwargs`` pass to
    ``run_sweep_cells`` (``mix_impl``, ``data_fn``, ``init_fn``,
    ``results``, ...)."""
    if not in_scan:
        raise NotImplementedError(
            "run_link_failure(in_scan=False) is the reference's legacy "
            "per-cell loop (benchmarks/common.py run_experiment), which the "
            "port replaces by the engine's unrolled mode")
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
