"""Batched experiment-sweep runner (port of ``benchmarks/sweep.py``):
declarative figure grids over the sweep engine (``repro_torch.core.sweep``),
with a wall-clock comparison against the legacy per-cell loop.

  PYTHONPATH=src python -m repro_torch.benchmarks.sweep --list
  PYTHONPATH=src python -m repro_torch.benchmarks.sweep --preset fig4 --dry-run
  PYTHONPATH=src python -m repro_torch.benchmarks.sweep --preset fig4   # + legacy baseline
  PYTHONPATH=src python -m repro_torch.benchmarks.sweep --preset fig6 --no-legacy
  PYTHONPATH=src python -m repro_torch.benchmarks.sweep --preset fig4 --full --seeds 0,1,2
  PYTHONPATH=src python -m repro_torch.benchmarks.sweep --preset fig4 --smoke --device cpu

Each preset re-expresses one paper figure (or ablation) as a list of
:class:`~repro_torch.benchmarks.common.SweepCell`, pure data.  Cells that
share a program shape (dataset × node count × robust rule) run as ONE
engine program, seeds, strategies, OOD placements and topology variants
on its experiment axis.  ``--dry-run`` prints the plan (groups,
experiment counts, the sample bank's estimated size) and touches no
device.  Runs take the CUDA card unless ``--device cpu`` is given.

The legacy baseline is one ``run_experiment`` (Algorithm 1 as a per-round
host loop over ``DecentralizedTrainer``) a cell, with the grid's backend
and device; ``programs`` presets skip it, as the reference's CLI does.
Records go to
``<out>/BENCH_sweep.json`` (``artifacts_torch/`` by default) under the
reference's section keys, and the rows to ``<out>/sweep_<preset>.json``.

``--shard [N]`` shards the engine's experiment axis over N ranks (default:
the fewest ranks at the least experiments a rank), one process a rank:

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.benchmarks.sweep \
      --preset edges --smoke --shard 2          # ranks share the cards
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.benchmarks.sweep \
      --preset fig4 --smoke --shard 2 --device cpu   # gloo on the CPU

Ranks outside the mesh (when N, or the rule, takes fewer ranks than the
world) run nothing and return no rows.  Only rank 0 prints and writes
records; after the sharded grid it runs the grid again unsharded and
writes the ``sharded/<preset>`` record (wall seconds of both, speedup,
metrics bit-identical).  ``--shard-scale
R1,R2,...`` times both at each round count instead and records the
crossover.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.benchmarks import (
    fig2_iid_vs_ood as fig2,
    fig4_strategies as fig4,
    fig5_location as fig5,
    fig6_topology as fig6,
)
from repro_torch.benchmarks.common import (
    DEFAULT_ARRIVAL_THRESHOLD,
    FULL,
    QUICK,
    BenchScale,
    byzantine_cells,
    edges_cells,
    group_cells,
    linkfail_cells,
    multisource_cells,
    participation_cells,
    run_experiment,
    run_sweep_cells,
)
from repro_torch.core.coeffs import program_for, state_nbytes
from repro_torch.core.dynamic import FaultSpec
from repro_torch.core.strategies import AggregationStrategy
from repro_torch.launch.mesh import init_distributed, make_sweep_mesh

__all__ = ["SweepPreset", "PRESETS", "register_preset", "SMOKE", "plan",
           "run_legacy_baseline", "main"]

# bytes per sample (x features, f32 / int32) for the bank-memory estimate
_SAMPLE_BYTES = {
    "mnist": 28 * 28 * 1 * 4,
    "fmnist": 28 * 28 * 1 * 4,
    "cifar10": 32 * 32 * 3 * 4,
    "cifar100": 32 * 32 * 3 * 4,
    "tinymem": 65 * 4,
}

#: ``--smoke``: the tiny scale (seconds), as the reference's CLI sets it
SMOKE = BenchScale(n_train=1500, n_test=300, rounds=6, local_epochs=2,
                   batch=16, steps_per_epoch=4, eval_every=2, eval_n=128)

DEFAULT_OUT = "artifacts_torch"


@dataclasses.dataclass(frozen=True)
class SweepPreset:
    """Registry entry: a figure's grid as a cell builder and a claim
    check.  ``programs=True`` runs the grid through in-loop coefficient
    programs (``coeff_mode="program"``; reactive link-failure cells need
    it) and records the stacks-vs-programs comparison; ``mix_impl`` is the
    whole grid's backend; ``fault_kwargs`` the ``FaultSpec`` of a fault
    preset (None: ``run_sweep_cells``' default when a cell sets a
    fault rate)."""

    name: str
    description: str
    build: Callable[..., list]               # (datasets, seeds, n_nodes) → cells
    verdict: Callable[[List[dict]], str]
    datasets: tuple = ("mnist",)
    seeds: tuple = (0, 1)
    programs: bool = False
    mix_impl: str = "einsum"
    fault_kwargs: Optional[dict] = None


PRESETS: Dict[str, SweepPreset] = {}


def register_preset(preset: SweepPreset) -> None:
    if preset.name in PRESETS:
        raise KeyError(f"preset {preset.name!r} already registered")
    PRESETS[preset.name] = preset


def _fig2_build(datasets, seeds, n_nodes):
    return fig2.cells(datasets=datasets, seeds=seeds, n_nodes=n_nodes)


def _fig4_build(datasets, seeds, n_nodes):
    return fig4.cells(datasets=datasets, seeds=seeds, n_nodes=n_nodes)


def _fig5_build(datasets, seeds, n_nodes):
    return fig5.cells(datasets=datasets, seeds=seeds, n_nodes=n_nodes)


def _fig6_build(datasets, seeds, n_nodes):
    return (fig6.degree_cells(datasets=datasets, seeds=seeds)
            + fig6.modularity_cells(datasets=datasets, seeds=seeds))


def _fig6_verdict(rows):
    deg = [r for r in rows if r.get("sweep", (None,))[0] == "degree"]
    mod = [r for r in rows if r.get("sweep", (None,))[0] == "modularity"]
    return fig6.verdict(deg, mod)


register_preset(SweepPreset(
    "fig2", "IID vs OOD propagation gap (baseline strategies, BA)",
    _fig2_build, fig2.verdict, seeds=(0,)))
register_preset(SweepPreset(
    "fig4", "topology-aware vs unaware strategies (6 strategies × seeds)",
    _fig4_build, fig4.verdict, seeds=(0, 1)))
register_preset(SweepPreset(
    "fig5", "OOD-placement sweep (degree rank 1..4 × strategies)",
    _fig5_build, fig5.verdict, seeds=(0,)))
register_preset(SweepPreset(
    "fig6", "topology sweep (BA degree param + SB modularity)",
    _fig6_build, _fig6_verdict, seeds=(0,)))


# betweenness is absent: it has no fixed-shape reactive form, so a
# reactive grid would serve nominal scores for it; eigenvector is the
# global centrality that the coefficient program recomputes on the
# surviving graph
LINKFAIL_STRATEGIES = ("unweighted", "degree", "eigenvector")
LINKFAIL_P = (0.0, 0.3, 0.6)


def _linkfail_build(datasets, seeds, n_nodes):
    """Reactive link-failure grid: strategies × p_fail on BA graphs, each
    round's centralities recomputed on the surviving graph in the loop."""
    return linkfail_cells(datasets=datasets, seeds=seeds, n_nodes=n_nodes,
                          strategies=LINKFAIL_STRATEGIES,
                          p_fails=LINKFAIL_P, reactive=True)


def _linkfail_verdict(rows):
    mean = lambda xs: sum(xs) / max(len(xs), 1)
    by = {}
    for r in rows:
        by.setdefault((r["strategy"], r.get("p_fail", 0.0)),
                      []).append(r["ood_auc"])
    parts = []
    for pf in sorted({k[1] for k in by}):
        deg = mean(by.get(("degree", pf), [0.0]))
        unw = mean(by.get(("unweighted", pf), [0.0]))
        parts.append(f"p={pf}: degree−unweighted OOD-AUC "
                     f"Δ={deg - unw:+.3f}")
    return ("reactive link failure (centralities on the surviving "
            "subgraph): " + "; ".join(parts))


register_preset(SweepPreset(
    "linkfail",
    "reactive link-failure robustness (strategies × p_fail, in-scan "
    "coefficient programs)",
    _linkfail_build, _linkfail_verdict, seeds=(0,), programs=True))


def _multisource_build(datasets, seeds, n_nodes):
    """k backdoor sources on the k highest-degree nodes (strategies ×
    source counts); the streaming arrival rounds read how more sources
    shorten the hop distances."""
    return multisource_cells(datasets=datasets, seeds=seeds,
                             n_nodes=n_nodes)


def _multisource_verdict(rows):
    mean = lambda xs: (sum(xs) / len(xs)) if xs else float("nan")
    by_k: Dict[int, Dict[str, list]] = {}
    for r in rows:
        k = r["sweep"][2]
        d = by_k.setdefault(k, {"auc": [], "arrival": []})
        d["auc"].append(r["ood_auc"])
        arr = r.get("analytics", {}).get("ood_arrival_mean")
        if arr is not None:
            d["arrival"].append(arr)
    parts = []
    for k in sorted(by_k):
        d = by_k[k]
        arr = (f"arrival≈{mean(d['arrival']):.1f}" if d["arrival"]
               else "arrival=n/a")
        parts.append(f"k={k}: ood_auc={mean(d['auc']):.3f} {arr}")
    ks = sorted(by_k)
    mono = all(mean(by_k[a]["auc"]) <= mean(by_k[b]["auc"]) + 0.02
               for a, b in zip(ks, ks[1:]))
    return ("multi-source OOD (more sources ⇒ faster propagation): "
            + "; ".join(parts)
            + "  [monotone ✓]" * mono + "  [non-monotone X]" * (not mono))


register_preset(SweepPreset(
    "multisource",
    "multi-source OOD placement (k sources × strategies, streaming "
    "arrival-round analytics)",
    _multisource_build, _multisource_verdict, seeds=(0,)))


def _edges_build(datasets, seeds, n_nodes):
    """Strategies × hub OOD on BA graphs, the whole grid mixed through
    ``mix_impl="edges"`` (padded-ELL neighbour tables, ``edges_kernel``)."""
    return edges_cells(datasets=datasets, seeds=seeds, n_nodes=n_nodes)


def _edges_verdict(rows):
    mean = lambda xs: (sum(xs) / len(xs)) if xs else float("nan")
    by = {}
    for r in rows:
        by.setdefault(r["strategy"], []).append(r["ood_auc"])
    parts = [f"{s}: ood_auc={mean(v):.3f}" for s, v in sorted(by.items())]
    return ("edge-list gossip (mix_impl='edges', O(n·dmax) mix traffic): "
            + "; ".join(parts))


register_preset(SweepPreset(
    "edges",
    "edge-list sparse gossip smoke (BA graphs through the padded-ELL "
    "segment kernel; pair with --n-nodes 64+)",
    _edges_build, _edges_verdict, seeds=(0,), mix_impl="edges"))


def _participation_build(datasets, seeds, n_nodes):
    """Activation rate × topology (ring, BA) × OOD placement (hub, leaf);
    rate 1.0 rows are the synchronous control."""
    return participation_cells(datasets=datasets, seeds=seeds,
                               n_nodes=n_nodes)


def _participation_verdict(rows):
    mean = lambda xs: (sum(xs) / len(xs)) if xs else float("nan")
    by: Dict[float, Dict[str, list]] = {}
    for r in rows:
        p = r["participation"]
        d = by.setdefault(r["participation_rate"],
                          {"auc": [], "act": [], "stale": []})
        d["auc"].append(r["ood_auc"])
        d["act"].append(p["activity_rate"])
        d["stale"].append(p["mean_staleness"])
    parts = [f"rate={rate}: ood_auc={mean(d['auc']):.3f} "
             f"activity={mean(d['act']):.2f} "
             f"staleness≈{mean(d['stale']):.2f}"
             for rate, d in sorted(by.items(), reverse=True)]
    ctrl = by.get(1.0)
    ctrl_ok = ctrl is not None and max(ctrl["stale"], default=0.0) == 0.0
    return ("partial participation (stale-plane gossip): "
            + "; ".join(parts)
            + ("  [rate-1.0 control stale-free ✓]" if ctrl_ok
               else "  [rate-1.0 control has staleness X]"))


register_preset(SweepPreset(
    "participation",
    "partial-participation gossip (activation rate × topology × OOD "
    "placement, staleness-aware stale-plane mixing)",
    _participation_build, _participation_verdict, seeds=(0,)))


def _byzantine_build(datasets, seeds, n_nodes):
    """Fault rate × topology × OOD placement × aggregation rule (mean,
    trimmed, median); rate-0.0 mean rows are the fault-free control."""
    return byzantine_cells(datasets=datasets, seeds=seeds, n_nodes=n_nodes)


def _byzantine_verdict(rows):
    mean = lambda xs: (sum(xs) / len(xs)) if xs else float("nan")
    by: Dict[tuple, list] = {}
    for r in rows:
        by.setdefault((r["fault_rate"], r["robust"]),
                      []).append(r["final_ood_acc_mean"])
    rates = sorted({k[0] for k in by})
    parts, recovered = [], True
    for rate in rates:
        cell = {rob: mean(by.get((rate, rob), []))
                for rob in ("mean", "trimmed", "median")}
        parts.append(f"rate={rate:g}: final_ood "
                     + " ".join(f"{rob}={v:.3f}"
                                for rob, v in cell.items()))
        if rate > 0:
            recovered &= (cell["trimmed"] >= cell["mean"] - 1e-6
                          and cell["median"] >= cell["mean"] - 1e-6)
    return ("byzantine faults (signflip, robust aggregation): "
            + "; ".join(parts)
            + ("  [robust ≥ mean under faults ✓]" if recovered
               else "  [robust < mean under faults X]"))


# byz_scale=12 makes the corruption decisive: a ×(−3) signflip barely
# moves a degree-weighted mean at n=16, while ×(−12) collapses the plain
# mean and leaves the order-statistic rules standing
register_preset(SweepPreset(
    "byzantine",
    "Byzantine fault injection (fault rate × topology × OOD placement × "
    "{mean, trimmed, median} aggregation)",
    _byzantine_build, _byzantine_verdict, seeds=(0,),
    fault_kwargs=dict(mode="signflip", byz_scale=12.0)))


# ----------------------------------------------------------------------
def plan(cells, scale) -> str:
    """The program plan of a cell grid; no device work."""
    lines = ["plan: group,experiments,distinct_datasets,rounds,"
             "est_bank_mib,cells"]
    for (ds, n, robust), idxs in group_cells(cells).items():
        dkeys = {(cells[i].seed, cells[i].ood_nodes()) for i in idxs}
        bank_mib = (len(dkeys) * scale.n_train
                    * _SAMPLE_BYTES.get(ds, 4096)) / 2**20
        names = ",".join(cells[i].label for i in idxs[:3])
        more = f",+{len(idxs) - 3}" if len(idxs) > 3 else ""
        tag = f"/{robust}" if robust != "mean" else ""
        lines.append(
            f"  {ds}/n{n}{tag}: E={len(idxs)} D={len(dkeys)} "
            f"R={scale.rounds} bank≈{bank_mib:.0f}MiB [{names}{more}]")
    lines.append(f"total cells: {len(cells)} "
                 f"({len(group_cells(cells))} compiled programs)")
    return "\n".join(lines)


def run_legacy_baseline(cells, scale, log=print, device=None,
                        mix_impl: str = "einsum") -> List[dict]:
    """The pre-engine path the grid is timed against: one
    ``run_experiment`` (Algorithm 1 as a per-round host loop) a cell, on
    its dataset, graph, strategy, OOD ranks, τ and seed, with the grid's
    ``mix_impl`` and ``device``.  As the reference's loop, it ignores the
    cell's fault rate, participation rate, robust rule, ``p_fail`` and
    ``reactive``."""
    rows = []
    for cell in cells:
        r = run_experiment(cell.dataset, cell.topo, cell.strategy,
                           ood_k=cell.ood_k, ood_ks=cell.ood_ks,
                           tau=cell.tau, seed=cell.seed, scale=scale,
                           device=device, mix_impl=mix_impl)
        log(f"  legacy {cell.label}: {r['secs']}s "
            f"ood_auc={r['ood_auc']:.3f}")
        rows.append(r)
    return rows


def _preset_fault(preset: SweepPreset) -> Optional[FaultSpec]:
    return None if preset.fault_kwargs is None else FaultSpec(
        **preset.fault_kwargs)


def main(argv: Optional[List[str]] = None) -> Optional[List[dict]]:
    """The CLI; returns the grid's rows (None for ``--list`` and
    ``--dry-run``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default=None,
                    help=f"one of {sorted(PRESETS)}")
    ap.add_argument("--list", action="store_true",
                    help="list registered presets and exit")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the program plan; no device work")
    ap.add_argument("--full", action="store_true", help="paper-scale runs")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny scale (seconds) for sanity runs")
    ap.add_argument("--datasets", default=None, help="comma list")
    ap.add_argument("--seeds", default=None, help="comma list of ints")
    ap.add_argument("--n-nodes", type=int, default=None)
    ap.add_argument("--no-legacy", action="store_true",
                    help="skip the per-cell wall-clock baseline")
    ap.add_argument("--unroll", action="store_true",
                    help="the engine's unrolled mode: per-round dispatch "
                         "(incremental metrics) instead of one loop")
    ap.add_argument("--shard", nargs="?", type=int, const=0, default=None,
                    metavar="N",
                    help="shard the experiment axis over N ranks (default: "
                         "the fewest at the least rows a rank); launch "
                         "with torchrun; also times the unsharded grid")
    ap.add_argument("--chunk-rounds", type=int, default=None,
                    help="run the round schedule in chunks of this many "
                         "rounds (bounds device memory for long runs)")
    ap.add_argument("--shard-scale", default=None, metavar="R1,R2,...",
                    help="with --shard: time sharded and unsharded at each "
                         "of these round counts and record the crossover")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    if args.list or args.preset is None:
        print("registered sweep presets:")
        for p in PRESETS.values():
            print(f"  {p.name:8s} {p.description} "
                  f"(default seeds={p.seeds})")
        return None
    if args.preset not in PRESETS:
        raise SystemExit(f"unknown preset {args.preset!r}; "
                         f"have {sorted(PRESETS)}")
    preset = PRESETS[args.preset]

    datasets = (tuple(args.datasets.split(","))
                if args.datasets else preset.datasets)
    seeds = (tuple(int(s) for s in args.seeds.split(","))
             if args.seeds else preset.seeds)
    n_nodes = args.n_nodes or (33 if args.full else 16)
    cells = preset.build(datasets, seeds, n_nodes)

    scale = SMOKE if args.smoke else FULL if args.full else QUICK
    if args.dry_run:  # plan only: no data, no device work
        print(f"preset {preset.name}: {preset.description}")
        print(plan(cells, scale))
        return None

    mesh, device = None, args.device
    if args.shard is not None:
        if args.unroll:
            raise SystemExit("--shard cannot combine with --unroll")
        import torch.distributed as dist

        device = init_distributed(args.device)
        mesh = make_sweep_mesh(args.shard or auto_ranks(
            len(cells), dist.get_world_size()))
        if mesh.index < 0:
            return []   # a rank outside the mesh holds no experiment
    elif args.shard_scale:
        raise SystemExit("--shard-scale requires --shard")
    # only the mesh's first rank prints and writes records
    lead = mesh is None or mesh.index == 0
    with (contextlib.nullcontext() if lead
          else contextlib.redirect_stdout(io.StringIO())):
        return _run(args, preset, cells, scale, n_nodes, datasets, seeds,
                    mesh, device, lead)


def auto_ranks(n_cells: int, world: int) -> int:
    """``--shard`` without N: E experiments on k ranks are padded to the
    next multiple of k, and the padding is wasted work, so take the fewest
    ranks that keep the least experiments a rank (the reference's rule,
    over the world's ranks)."""
    per = -(-n_cells // world)          # least rows a rank
    return -(-n_cells // per)           # fewest ranks at it


def _run(args, preset, cells, scale, n_nodes, datasets, seeds, mesh,
         device, lead) -> List[dict]:
    print(f"preset {preset.name}: {len(cells)} cells "
          f"(datasets={datasets}, seeds={seeds}, n_nodes={n_nodes})")
    print(plan(cells, scale))
    if mesh is not None:
        print(f"sharding the experiment axis over {mesh.size} rank(s) "
              f"(E={len(cells)}, padding {(-len(cells)) % mesh.size}); "
              f"chunk_rounds={args.chunk_rounds}")

    coeff_mode = "program" if preset.programs else "stack"
    fault = _preset_fault(preset)
    common = dict(scale=scale, mix_impl=preset.mix_impl, fault=fault,
                  device=device)
    if args.shard_scale:
        _run_shard_scale(args, preset, cells, mesh, n_nodes, coeff_mode,
                         common, lead)
        return []
    t0 = time.time()
    rows = run_sweep_cells(cells, unroll_eval=args.unroll, mesh=mesh,
                           chunk_rounds=args.chunk_rounds,
                           coeff_mode=coeff_mode, log=print, **common)
    engine_secs = time.time() - t0
    print(f"\nsweep engine: {len(cells)} experiments in "
          f"{engine_secs:.1f}s wall-clock "
          f"({engine_secs / len(cells):.2f}s/experiment amortized"
          f"{', in-scan coefficient programs' if preset.programs else ''})")

    if rows and "analytics" in rows[0]:
        # the streaming digest against its host oracle, arrival stats, and
        # the metric memory of O(E·n) summaries against (E, R, n) histories
        devs = [r["analytics"]["stream_vs_host_max_dev"] for r in rows]
        arrivals = [r["analytics"]["ood_arrival_mean"] for r in rows
                    if r["analytics"]["ood_arrival_mean"] is not None]
        history_bytes = len(cells) * scale.rounds * n_nodes * 3 * 4
        summary_bytes = len(cells) * n_nodes * 7 * 4
        bench_path = _update_bench(
            lead, args.out, f"analytics/{preset.name}", {
            "preset": preset.name,
            "experiments": len(cells),
            "rounds": scale.rounds,
            "n_nodes": n_nodes,
            "arrival_threshold": DEFAULT_ARRIVAL_THRESHOLD,
            "max_stream_vs_host_dev": max(devs),
            "mean_ood_arrival_round": (round(sum(arrivals) / len(arrivals),
                                             2) if arrivals else None),
            "rows_with_arrival": len(arrivals),
            "history_metric_bytes": history_bytes,
            "streaming_summary_bytes": summary_bytes,
            "bytes_ratio": round(history_bytes / summary_bytes, 1),
        })
        apath = _extract_analytics(lead, args.out)
        print(f"streaming analytics: max in-scan vs host-oracle deviation "
              f"{max(devs):.2e} over {len(cells)} experiments; "
              f"summaries {summary_bytes / 2**10:.1f} KiB vs "
              f"{history_bytes / 2**10:.1f} KiB of metric history "
              f"({history_bytes / summary_bytes:.0f}× smaller)")
        print(f"analytics record → {bench_path} (sections extracted to "
              f"{apath})")

    if rows and "participation" in rows[0]:
        mean = lambda xs: (sum(xs) / len(xs)) if xs else None
        by_rate: Dict[float, List[dict]] = {}
        for r in rows:
            by_rate.setdefault(r["participation_rate"], []).append(r)
        rate_rec = {
            f"{rate:g}": {
                "cells": len(rs),
                "ood_auc": round(mean([r["ood_auc"] for r in rs]), 4),
                "activity_rate": round(mean(
                    [r["participation"]["activity_rate"] for r in rs]), 4),
                "mean_staleness": round(mean(
                    [r["participation"]["mean_staleness"] for r in rs]), 4),
                "max_final_staleness": max(
                    r["participation"]["max_final_staleness"] for r in rs),
                "local_steps_total": sum(
                    r["participation"]["local_steps_total"] for r in rs),
            }
            for rate, rs in sorted(by_rate.items(), reverse=True)
        }
        ctrl = by_rate.get(1.0, [])
        bench_path = _update_bench(
            lead, args.out, f"participation/{preset.name}", {
            "preset": preset.name,
            "experiments": len(cells),
            "rounds": scale.rounds,
            "n_nodes": n_nodes,
            "mode": "bernoulli",
            "rates": rate_rec,
            "rate1_control_stale_free": bool(ctrl) and all(
                r["participation"]["mean_staleness"] == 0.0 for r in ctrl),
        })
        print(f"participation record → {bench_path}")

    if rows and "fault" in rows[0]:
        mean = lambda xs: (sum(xs) / len(xs)) if xs else None
        by_cell: Dict[tuple, List[dict]] = {}
        for r in rows:
            by_cell.setdefault((r["fault_rate"], r["robust"]),
                               []).append(r)
        grid_rec = {
            f"{rate:g}/{rob}": {
                "cells": len(rs),
                "ood_auc": round(mean([r["ood_auc"] for r in rs]), 4),
                "final_ood_acc": round(mean(
                    [r["final_ood_acc_mean"] for r in rs]), 4),
                "fault_round_rate": round(mean(
                    [r["fault"]["fault_round_rate"] for r in rs]), 4),
            }
            for (rate, rob), rs in sorted(by_cell.items())
        }
        nz_rates = sorted({k[0] for k in by_cell if k[0] > 0})
        final = lambda rate, rob: mean(
            [r["final_ood_acc_mean"] for r in by_cell.get((rate, rob), [])])
        recovered = bool(nz_rates) and all(
            final(rate, rob) >= final(rate, "mean") - 1e-6
            for rate in nz_rates for rob in ("trimmed", "median"))
        bench_path = _update_bench(
            lead, args.out, f"byzantine/{preset.name}", {
            "preset": preset.name,
            "experiments": len(cells),
            "rounds": scale.rounds,
            "n_nodes": n_nodes,
            "fault_mode": "signflip",
            "grid": grid_rec,
            "robust_recovers_vs_mean": recovered,
        })
        print(f"byzantine record → {bench_path}")

    if mesh is not None and lead:
        # the same grid unsharded, on rank 0 alone
        t0 = time.time()
        single_rows = run_sweep_cells(cells, coeff_mode=coeff_mode,
                                      **common)
        single_secs = time.time() - t0
        identical = all(
            a["iid_auc"] == b["iid_auc"] and a["ood_auc"] == b["ood_auc"]
            and a["final_ood_acc_mean"] == b["final_ood_acc_mean"]
            for a, b in zip(rows, single_rows))
        print(f"single-device scanned path: {single_secs:.1f}s wall-clock "
              f"→ sharded speedup {single_secs / max(engine_secs, 1e-9):.2f}×"
              f"  (metrics bit-identical: {identical})")
        bench_path = _update_bench(
            lead, args.out, f"sharded/{preset.name}", {
            "preset": preset.name,
            "experiments": len(cells),
            "rounds": scale.rounds,
            "n_nodes": n_nodes,
            "devices": mesh.size,
            "chunk_rounds": args.chunk_rounds,
            "sharded_secs": round(engine_secs, 2),
            "single_device_secs": round(single_secs, 2),
            "speedup": round(single_secs / max(engine_secs, 1e-9), 3),
            "bit_identical_metrics": bool(identical),
        })
        print(f"sharded-vs-single wall-clock → {bench_path}")

    if preset.programs:
        # the same grid with its coefficients materialized as (E, R, n, n)
        # stacks: the host memory and wall-clock of the programs
        t0 = time.time()
        stack_rows = run_sweep_cells(cells, mesh=mesh,
                                     chunk_rounds=args.chunk_rounds,
                                     coeff_mode="stack", **common)
        stack_secs = time.time() - t0
        identical = all(
            a["iid_auc"] == b["iid_auc"] and a["ood_auc"] == b["ood_auc"]
            for a, b in zip(rows, stack_rows))
        c0 = cells[0]
        _, state0 = program_for(
            c0.topo, AggregationStrategy(c0.strategy, tau=c0.tau,
                                         seed=c0.seed),
            p_fail=c0.p_fail, reactive=c0.reactive)
        program_bytes = state_nbytes(state0) * len(cells)
        stack_bytes = len(cells) * scale.rounds * n_nodes * n_nodes * 4
        secs_ratio = engine_secs / max(stack_secs, 1e-9)
        print(f"coefficient stacks: {stack_secs:.1f}s wall-clock, "
              f"{stack_bytes / 2**20:.1f} MiB of host coefficients vs "
              f"{program_bytes / 2**10:.1f} KiB program state "
              f"({stack_bytes / max(program_bytes, 1):.0f}× smaller); "
              f"metrics bit-identical: {identical}")
        verdict = "improved ✓" if secs_ratio < 1.5 else "regressed ✗"
        print(f"programs-vs-stacks wall-clock ratio {secs_ratio:.2f}× "
              f"(the reference's pre-pruning record 1.82×) — {verdict}")
        bench_path = _update_bench(
            lead, args.out, f"coeff_programs/{preset.name}", {
                "preset": preset.name,
                "experiments": len(cells),
                "rounds": scale.rounds,
                "n_nodes": n_nodes,
                "reactive": bool(c0.reactive),
                "program_secs": round(engine_secs, 2),
                "stack_secs": round(stack_secs, 2),
                "secs_ratio": round(secs_ratio, 3),
                "pre_pruning_secs_ratio": 1.82,
                "ratio_improved": bool(secs_ratio < 1.5),
                "stack_coeff_bytes": stack_bytes,
                "program_state_bytes": program_bytes,
                "bytes_ratio": round(stack_bytes / max(program_bytes, 1), 1),
                "bit_identical_metrics": bool(identical),
            })
        print(f"stacks-vs-programs record → {bench_path}")

    if not args.no_legacy and preset.programs:
        print("\n(legacy per-config baseline skipped: programs presets "
              "compare against the materialized-stack engine run instead)")
    elif not args.no_legacy and lead:
        t0 = time.time()
        run_legacy_baseline(cells, scale, device=device,
                            mix_impl=preset.mix_impl)
        legacy_secs = time.time() - t0
        print(f"legacy per-config loop: {len(cells)} experiments in "
              f"{legacy_secs:.1f}s wall-clock "
              f"({legacy_secs / len(cells):.2f}s/experiment)")
        print(f"speedup: {legacy_secs / max(engine_secs, 1e-9):.2f}× "
              f"(batched engine vs legacy loop)")

    print("\n=== verdict ===")
    print(" •", preset.verdict(rows))

    path = f"{args.out}/sweep_{preset.name}.json"
    if lead:
        os.makedirs(args.out, exist_ok=True)
        with open(path, "w") as f:
            json.dump(rows, f, indent=1, default=_json_default)
    print(f"rows → {path}")
    return rows


def _linfit(xs, ys):
    """Least-squares ``(intercept, slope)`` of seconds against rounds."""
    b, a = np.polyfit(np.asarray(xs, float), np.asarray(ys, float), 1)
    return float(a), float(b)


def _crossover_from_entries(entries):
    """The sharded-vs-single crossover in rounds: interpolated where the
    speedup crosses 1.0 between two measured sizes, else extrapolated from
    each path's linear fit (secs = fixed + slope·rounds); None when the
    sharded slope is not the smaller."""
    for lo, hi in zip(entries, entries[1:]):
        s0, s1 = lo["speedup"], hi["speedup"]
        if (s0 - 1.0) * (s1 - 1.0) <= 0 and s0 != s1:
            frac = (1.0 - s0) / (s1 - s0)
            return (round(lo["rounds"]
                          + frac * (hi["rounds"] - lo["rounds"]), 1),
                    "measured")
    xs = [e["rounds"] for e in entries]
    a_sh, b_sh = _linfit(xs, [e["sharded_secs"] for e in entries])
    a_si, b_si = _linfit(xs, [e["single_device_secs"] for e in entries])
    if b_sh < b_si and a_sh > a_si:
        return round((a_sh - a_si) / (b_si - b_sh), 1), "extrapolated"
    return None, ("sharded per-round cost is not below single-device "
                  "on this host — no crossover at any scale")


def _run_shard_scale(args, preset, cells, mesh, n_nodes, coeff_mode,
                     common, lead) -> None:
    """``--shard-scale``: the grid timed sharded (every rank) and unsharded
    (rank 0) at each round count; the ``sharded/<preset>`` record holds
    the crossover rather than one speedup."""
    sizes = sorted({int(r) for r in args.shard_scale.split(",")})
    if len(sizes) < 2:
        raise SystemExit("--shard-scale needs ≥ 2 round counts")
    kw = dict(common, coeff_mode=coeff_mode)
    entries = []
    for r in sizes:
        kw["scale"] = dataclasses.replace(common["scale"], rounds=r)
        t0 = time.time()
        rows_sh = run_sweep_cells(cells, mesh=mesh,
                                  chunk_rounds=args.chunk_rounds, **kw)
        sh = time.time() - t0
        if not lead:
            continue
        t0 = time.time()
        rows_si = run_sweep_cells(cells, **kw)
        si = time.time() - t0
        identical = all(
            a["iid_auc"] == b["iid_auc"] and a["ood_auc"] == b["ood_auc"]
            for a, b in zip(rows_sh, rows_si))
        entries.append({
            "rounds": r,
            "sharded_secs": round(sh, 2),
            "single_device_secs": round(si, 2),
            "speedup": round(si / max(sh, 1e-9), 3),
            "bit_identical_metrics": bool(identical),
        })
        print(f"  R={r}: sharded {sh:.1f}s vs single {si:.1f}s "
              f"→ speedup {si / max(sh, 1e-9):.3f}× "
              f"(bit-identical: {identical})")
    if not lead:
        return
    crossover, how = _crossover_from_entries(entries)
    xs = [e["rounds"] for e in entries]
    a_sh, b_sh = _linfit(xs, [e["sharded_secs"] for e in entries])
    a_si, b_si = _linfit(xs, [e["single_device_secs"] for e in entries])
    bench_path = _update_bench(lead, args.out, f"sharded/{preset.name}", {
        "preset": preset.name,
        "experiments": len(cells),
        "n_nodes": n_nodes,
        "devices": mesh.size,
        "physical_cpus": os.cpu_count(),
        "chunk_rounds": args.chunk_rounds,
        "scale_sweep": entries,
        "sharded_fixed_secs": round(a_sh, 2),
        "sharded_secs_per_round": round(b_sh, 4),
        "single_fixed_secs": round(a_si, 2),
        "single_secs_per_round": round(b_si, 4),
        "crossover_rounds": crossover,
        "crossover_kind": how,
    })
    print("\n=== verdict ===")
    if crossover is not None:
        print(f" • single-vs-sharded crossover at R≈{crossover} ({how}); "
              f"fixed overhead {a_sh - a_si:+.1f}s, per-round "
              f"{b_sh:.3f}s vs {b_si:.3f}s")
    else:
        print(f" • no crossover: {how} (fixed {a_sh - a_si:+.1f}s, "
              f"per-round sharded {b_sh:.3f}s vs single {b_si:.3f}s)")
    print(f"sharded scale sweep → {bench_path}")


def _update_bench(lead: bool, out_dir: str, section: str,
                  payload: dict) -> str:
    """Merge one section into ``<out_dir>/BENCH_sweep.json`` (on the
    mesh's first rank only); sections are keyed ``kind/preset`` so
    successive presets accumulate."""
    path = f"{out_dir}/BENCH_sweep.json"
    if not lead:
        return path
    os.makedirs(out_dir, exist_ok=True)
    bench = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                loaded = json.load(f)
            if isinstance(loaded, dict) and "preset" not in loaded:
                bench = loaded
        except ValueError:
            pass
    bench[section] = payload
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)
    return path


def _extract_analytics(lead: bool, out_dir: str) -> str:
    """Mirror the ``analytics/*`` sections into
    ``<out_dir>/BENCH_sweep_analytics.json`` (on the first rank only)."""
    apath = f"{out_dir}/BENCH_sweep_analytics.json"
    if not lead:
        return apath
    path = f"{out_dir}/BENCH_sweep.json"
    bench = {}
    if os.path.exists(path):
        with open(path) as f:
            bench = json.load(f)
    sections = {k: v for k, v in bench.items()
                if k.startswith("analytics/")}
    with open(apath, "w") as f:
        json.dump(sections, f, indent=1)
    return apath


def _json_default(o):
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


if __name__ == "__main__":
    main()
