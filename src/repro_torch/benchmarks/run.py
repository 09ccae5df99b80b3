"""Benchmark entry point (port of ``benchmarks/run.py``): one section per
paper figure, the ablations, the gossip-cost and mix tables and the fleet
serving benchmark, as ``name,us_per_call,derived`` CSV rows and one JSON
file a section under ``--out`` (``artifacts_torch/`` by default).

  PYTHONPATH=src python -m repro_torch.benchmarks.run            # QUICK scale
  PYTHONPATH=src python -m repro_torch.benchmarks.run --full     # paper scale
  PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig4,mix
  PYTHONPATH=src python -m repro_torch.benchmarks.run --only serve --device cpu

Sections: fig2, fig4, fig5, fig6, ablations, gossip, mix (the port's
``gossip_cost``) and serve.  The reference's ``roofline`` section models
a TPU v5e over its memory dry-run and is not ported: ``--only roofline``
raises (ROADMAP Queue 1 [tooling]).  Runs take the CUDA card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

__all__ = ["SECTIONS", "main"]

SECTIONS = ("fig2", "fig4", "fig5", "fig6", "ablations", "gossip", "mix",
            "serve")


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, default=float)


def main(argv: Optional[List[str]] = None) -> List[str]:
    """The CLI; returns the verdict lines."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true", help="paper-scale runs")
    ap.add_argument("--only", default=None,
                    help="comma list: " + ",".join(SECTIONS))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default="artifacts_torch")
    args = ap.parse_args(argv)

    sections = args.only.split(",") if args.only else list(SECTIONS)
    if "roofline" in sections:
        raise NotImplementedError(
            "the roofline section models a TPU v5e over the reference's "
            "jaxpr memory dry-run, which the port does not have (ROADMAP "
            "Queue 1 [tooling])")
    unknown = sorted(set(sections) - set(SECTIONS))
    if unknown:
        raise SystemExit(f"unknown sections {unknown}; have {SECTIONS}")

    from repro_torch import resolve_device
    from repro_torch.benchmarks.common import FULL, QUICK

    device = resolve_device(args.device)
    scale = FULL if args.full else QUICK
    datasets = (("mnist", "fmnist", "tinymem", "cifar10", "cifar100")
                if args.full else ("mnist", "fmnist"))
    seeds = (0, 1, 2) if args.full else (0,)
    n_nodes = 33 if args.full else 16
    os.makedirs(args.out, exist_ok=True)
    verdicts = []
    t_start = time.time()

    print("name,us_per_call,derived")

    if "fig2" in sections:
        from repro_torch.benchmarks import fig2_iid_vs_ood as fig2

        rows = fig2.run(datasets=datasets[:2], ba_p=(2,), n_nodes=n_nodes,
                        seeds=seeds, scale=scale, device=device)
        verdicts.append(fig2.verdict(rows))
        _dump(rows, f"{args.out}/fig2.json")

    if "fig4" in sections:
        from repro_torch.benchmarks import fig4_strategies as fig4

        rows = fig4.run(datasets=datasets[:2],
                        ba_p=(1, 2) if args.full else (2,), n_nodes=n_nodes,
                        seeds=seeds, scale=scale, device=device)
        verdicts.append(fig4.verdict(rows))
        _dump(rows, f"{args.out}/fig4.json")

    if "fig5" in sections:
        from repro_torch.benchmarks import fig5_location as fig5

        rows = fig5.run(datasets=datasets[:1], n_nodes=n_nodes, seeds=seeds,
                        scale=scale, device=device)
        verdicts.append(fig5.verdict(rows))
        _dump(rows, f"{args.out}/fig5.json")

    if "fig6" in sections:
        from repro_torch.benchmarks import fig6_topology as fig6

        d = fig6.run_degree(datasets=datasets[:1], seeds=seeds, scale=scale,
                            device=device)
        m = fig6.run_modularity(datasets=datasets[:1], seeds=seeds,
                                scale=scale, device=device)
        if args.full:
            fig6.run_nodecount(datasets=datasets[:1], seeds=seeds,
                               scale=scale, device=device)
        verdicts.append(fig6.verdict(d, m))
        _dump(d + m, f"{args.out}/fig6.json")

    if "ablations" in sections:
        from repro_torch.benchmarks import ablations

        z = ablations.run_centrality_zoo(seeds=seeds, scale=scale,
                                         device=device)
        t = ablations.run_tau_sweep(seeds=seeds, scale=scale, device=device)
        f = ablations.run_link_failure(seeds=seeds, scale=scale,
                                       device=device)
        h = ablations.run_heterogeneity(seeds=seeds, scale=scale,
                                        device=device)
        aware = [r for r in z if r["strategy"] != "unweighted"]
        verdicts.append(
            "ablations: all %d centrality metrics beat unweighted on OOD "
            "(%.3f–%.3f vs %.3f); τ≤0.1 plateau; degree OOD at 60%% link "
            "failure: %.3f" % (
                len(aware),
                min(r["ood_auc"] for r in aware),
                max(r["ood_auc"] for r in aware),
                next(r["ood_auc"] for r in z if r["strategy"] == "unweighted"),
                next((r["ood_auc"] for r in f
                      if r["strategy"] == "degree" and r["p_fail"] == 0.6),
                     -1)))
        _dump(dict(centrality=z, tau=t, linkfail=f, heterogeneity=h),
              f"{args.out}/ablations.json")

    if "gossip" in sections:
        from repro_torch.benchmarks import gossip_cost

        rows = gossip_cost.run(device=device)
        _dump(rows, f"{args.out}/gossip_cost.json")

    if "mix" in sections:
        from repro_torch.benchmarks import gossip_cost

        rec = gossip_cost.run_mix(smoke=not args.full, device=device,
                                  out_path=f"{args.out}/BENCH_mix.json")
        verdicts.append(
            "mix kernel: fused plane %s the legacy per-row path "
            "(wall %.1fx, modeled HBM bytes %.1fx; 1 launch vs %d "
            "programs per mix)" % (
                "dominates" if rec["fused_vs_rows"]["dominates"]
                else "DOES NOT dominate",
                rec["fused_vs_rows"]["wall_speedup"],
                rec["fused_vs_rows"]["hbm_bytes_ratio"],
                rec["impls"]["pallas_rows"]["kernel_programs_per_mix"]))

    if "serve" in sections:
        from repro_torch.benchmarks import serve_bench

        code = serve_bench.main(
            (["--smoke"] if not args.full else ["--fleets", "2,4,8"])
            + ["--out", args.out, "--device", str(device)])
        with open(f"{args.out}/BENCH_serve.json") as fh:
            rec = json.load(fh)
        best = max(rec["fleets"], key=lambda f: f["vmapped_speedup"])
        verdicts.append(
            "serving: fleet-vmapped continuous batching %s the per-node "
            "loop (best %.2fx at n=%d; %.0f tok/s; outputs identical and "
            "post-gossip swap in place: %s)" % (
                "beats" if code == 0 and all(
                    f["vmapped_speedup"] > 1 for f in rec["fleets"])
                else "DOES NOT beat",
                best["vmapped_speedup"], best["n_nodes"],
                best["fleet_vmapped"]["tokens_per_sec"],
                rec["all_checks_passed"]))

    print("\n=== verdicts (paper-claim checks) ===")
    for v in verdicts:
        print(" •", v)
    print(f"total bench time: {time.time() - t_start:.0f}s")
    return verdicts


if __name__ == "__main__":
    main()
