"""Perf hill-climbing over the analytic roofline (port of
``benchmarks/perf_iterations.py``): hypothesis → change → re-derive →
verdict, on the H100.

Four (arch × shape) pairs from the roofline table, each replanned by the
reference's iterations (a ``ParallelConfig`` change a step) and re-derived
with the port's ``benchmarks/roofline.analyze_pair``, whose terms are the
reference's formulas over the H100 SXM5 datasheet constants — every time
here is **modeled**, not measured:

  A. stablelm-1.6b × train_4k     — the paper's gossip tier (16 nodes),
                                     collective-bound through TP;
  B. deepseek-v2-236b × train_4k  — the most collective-bound pair; a
                                     (tp, micro) grid, then device-limited
                                     routing;
  C. llama4-scout × decode_32k    — the corrected model, one replica;
  D. gemma2-27b × train_4k        — tp 16 → 2; compute-bound on the
                                     reference's constants, still
                                     collective-bound on the H100's.

Pair B picks the best candidate that fits the card's memory, so its plan
may differ from the reference's (80 GB against 16 GiB).  ``--verify``
runs the port's dry-run (``launch/dryrun.dry_run_pair``: the real step on
fake tensors, over the production mesh) on each winning plan and prints
its ``run_s`` (the reference reads ``compile_s``):

  PYTHONPATH=src python -m repro_torch.benchmarks.perf_iterations [--verify]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback
from typing import Dict, Optional

from repro_torch.benchmarks.roofline import analyze_pair
from repro_torch.configs.registry import get_parallel

__all__ = ["show", "bound", "pair_a", "pair_b", "pair_c", "pair_d",
           "verify_plans", "main"]


def show(tag, r):
    print(f"  {tag:44s} comp {r['t_compute_s']:9.3e}  mem {r['t_memory_s']:9.3e}"
          f"  coll {r['t_collective_s']:9.3e}  dom {r['dominant']:10s}"
          f"  fits {'y' if r['fits_hbm'] else 'N'}")
    return r


def bound(r):
    return max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])


def pair_a(results):
    """stablelm-1.6b × train_4k."""
    arch, shape = "stablelm-1.6b", "train_4k"
    print(f"\n=== Pair A: {arch} × {shape} ===")
    p0 = get_parallel(arch)
    base = show("baseline n16·tp16·f1 micro2 gossip/step",
                analyze_pair(arch, shape, pcfg=p0))

    # iter 1: amortize gossip over the paper's round (15 steps/round)
    p1 = dataclasses.replace(p0, steps_per_round=15)
    i1 = show("iter1: gossip amortized (steps_per_round=15)",
              analyze_pair(arch, shape, pcfg=p1))

    # iter 2 (refuted in the reference): sparse circulant gossip on BA-16
    i2 = show("iter2: sparse circulant gossip (BA-16)",
              analyze_pair(arch, shape, pcfg=p1, gossip_schedule="sparse"))

    # iter 3: replan n_nodes=64 · tp=4 (less TP traffic, more gossip nodes)
    p3 = dataclasses.replace(p0, n_nodes=64, tp_degree=4, microbatch=1,
                             steps_per_round=15)
    i3 = show("iter3: replan n64·tp4·f1 (+amortized gossip)",
              analyze_pair(arch, shape, pcfg=p3))

    # iter 4: n64·tp2·f2 — trade residual TP traffic for a small FSDP gather
    p4 = dataclasses.replace(p0, n_nodes=64, tp_degree=2, microbatch=1,
                             steps_per_round=15)
    i4 = show("iter4: replan n64·tp2·f2", analyze_pair(arch, shape, pcfg=p4))

    results["A"] = dict(arch=arch, shape=shape,
                        baseline=base, iters=[i1, i2, i3, i4],
                        speedup=bound(base) / bound(i4))
    print(f"  → bound {bound(base):.3f}s → {bound(i4):.3f}s "
          f"({results['A']['speedup']:.2f}×)")
    return dataclasses.replace(p4)


def pair_b(results):
    """deepseek-v2-236b × train_4k — grid over (tp, micro) + amortization."""
    arch, shape = "deepseek-v2-236b", "train_4k"
    print(f"\n=== Pair B: {arch} × {shape} ===")
    p0 = get_parallel(arch)
    base = show("baseline n1·tp16·f16 micro16",
                analyze_pair(arch, shape, pcfg=p0))

    print("  -- candidate grid (napkin-math all, then pick) --")
    best, best_p = base, p0
    for tp in (4, 8, 16, 32):
        for micro in (4, 8, 16):
            if 256 % tp:
                continue
            p = dataclasses.replace(p0, tp_degree=tp, microbatch=micro,
                                    chunked_ce=1024)
            r = analyze_pair(arch, shape, pcfg=p)
            tag = f"  cand tp{tp} f{p.fsdp} micro{micro}"
            show(tag, r)
            if r["fits_hbm"] and bound(r) < bound(best):
                best, best_p = r, p
    i1 = best
    print(f"  iter1 pick: tp{best_p.tp_degree} f{best_p.fsdp} "
          f"micro{best_p.microbatch}")

    # iter 2: device-limited routing (DeepSeek-V2 §2.1.3, M=3): each token
    # reaches ≤3 expert-parallel groups → all-to-all bytes ×(3/6)
    p2 = dataclasses.replace(best_p, moe_group_limit=3)
    i2 = show("iter2: + device-limited routing M=3",
              analyze_pair(arch, shape, pcfg=p2))
    best_p = p2

    results["B"] = dict(arch=arch, shape=shape, baseline=base, iters=[i1, i2],
                        best_plan=dict(tp=best_p.tp_degree, fsdp=best_p.fsdp,
                                       micro=best_p.microbatch,
                                       moe_group_limit=3),
                        speedup=bound(base) / bound(i2))
    print(f"  → bound {bound(base):.3f}s → {bound(i2):.3f}s "
          f"({results['B']['speedup']:.2f}×)")
    return best_p


def pair_c(results):
    """llama4-scout × decode_32k — model correction + replica
    consolidation."""
    arch, shape = "llama4-scout-17b-a16e", "decode_32k"
    print(f"\n=== Pair C: {arch} × {shape} ===")
    p0 = get_parallel(arch)
    # The reference's first model charged a per-step FSDP weight
    # all-gather (0.236 s of collective on its TPU constants); its compiled
    # dry-run showed the 2-D-sharded weights consumed sharded, with no
    # gather, and the corrected model is the baseline here.
    base = show("baseline (corrected model) n2·tp16·f8",
                analyze_pair(arch, shape, pcfg=p0))

    # iter: serving consolidation — 1 replica, 128-deep batch
    p1 = dataclasses.replace(p0, n_nodes=1)
    i1 = show("iter1: consolidate to 1 replica (batch 128)",
              analyze_pair(arch, shape, pcfg=p1))

    results["C"] = dict(arch=arch, shape=shape, baseline=base, iters=[i1],
                        refuted_model_term_s=0.236,
                        speedup=bound(base) / bound(i1))
    print(f"  → bound {bound(base):.5f}s → {bound(i1):.5f}s "
          f"({results['C']['speedup']:.2f}×)")
    return p1


def pair_d(results):
    """gemma2-27b × train_4k — a near-balanced baseline; the reference's
    constants reach compute-bound, the line says what the H100's reach."""
    arch, shape = "gemma2-27b", "train_4k"
    print(f"\n=== Pair D: {arch} × {shape} (extra) ===")
    p0 = get_parallel(arch)
    base = show("baseline n4·tp16·f4 micro8",
                analyze_pair(arch, shape, pcfg=p0))

    # iter 1: amortize gossip + chunked CE (frees memory for the replans)
    p1 = dataclasses.replace(p0, steps_per_round=15, chunked_ce=1024)
    i1 = show("iter1: amortized gossip + chunked CE",
              analyze_pair(arch, shape, pcfg=p1))

    # iter 2: TP-width sweep (TP bytes ∝ toks_chip·(m−1)/m; wider fsdp
    # shards the batch so both factors shrink): tp 16→4
    p2 = dataclasses.replace(p1, tp_degree=4)
    i2 = show("iter2: tp4·f16", analyze_pair(arch, shape, pcfg=p2))

    # iter 3: tp2·f32 — last step before the FSDP gather dominates
    p3 = dataclasses.replace(p1, tp_degree=2)
    i3 = show("iter3: tp2·f32", analyze_pair(arch, shape, pcfg=p3))

    results["D"] = dict(arch=arch, shape=shape, baseline=base,
                        iters=[i1, i2, i3],
                        speedup=bound(base) / bound(i3))
    print(f"  → bound {bound(base):.3f}s → {bound(i3):.3f}s "
          f"({results['D']['speedup']:.2f}×) — {i3['dominant']}-bound")
    return p3


def verify_plans(pb) -> Dict[str, tuple]:
    """The winning plans the reference verifies: (arch, shape, the
    ``ParallelConfig`` overrides), B's from this run's pick."""
    return {
        "A": ("stablelm-1.6b", "train_4k",
              dict(n_nodes=64, tp_degree=4, microbatch=1)),
        "B": ("deepseek-v2-236b", "train_4k",
              dict(tp_degree=pb.tp_degree, microbatch=pb.microbatch,
                   chunked_ce=1024)),
        "C": ("llama4-scout-17b-a16e", "decode_32k", dict(n_nodes=1)),
        "D": ("gemma2-27b", "train_4k", dict(tp_degree=2, chunked_ce=1024)),
    }


def verify(plans) -> Dict[str, Optional[Dict]]:
    """``dry_run_pair`` on each plan over the production mesh; a plan's
    record, or None where it raised (its traceback printed)."""
    from repro_torch.launch.dryrun import dry_run_pair

    out = {}
    for tag, (arch, shape, overrides) in plans.items():
        p = dataclasses.replace(get_parallel(arch), **overrides)
        try:
            r = dry_run_pair(arch, shape, False, pcfg=p)
        except Exception:   # a plan the step cannot run; the others go on
            print(f"verify {tag}: FAILED")
            print(traceback.format_exc()[-1500:])
            out[tag] = None
            continue
        print(f"verify {tag}: RAN in {r['run_s']} s, peak "
              f"{r['memory']['peak_per_device'] / 1e9:.2f} GB a device, "
              f"fits {r['fits_hbm']}")
        out[tag] = r
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--verify", action="store_true",
                    help="run the dry-run on the winning plans over the "
                         "production mesh (fake tensors; no device)")
    ap.add_argument("--out", default="artifacts_torch/perf_iterations.json")
    args = ap.parse_args(argv)

    print("modeled: H100 SXM5 datasheet constants (benchmarks/roofline.py), "
          "not measured")
    results = {}
    pair_a(results)
    pb = pair_b(results)
    pair_c(results)
    pair_d(results)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(results, fh, indent=1, default=float)
    print(f"\nwritten → {args.out}")

    if args.verify:
        results["verify"] = verify(verify_plans(pb))
    return results


if __name__ == "__main__":
    res = main()
    raise SystemExit(1 if None in res.get("verify", {}).values() else 0)
