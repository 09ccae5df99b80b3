"""README's Fig. 4 TinyMem command cut to a few rounds: the six strategies
as one sweep-engine grid (E = 6) of GPT-2-TinyMem on BA(n, 2), at FULL's
data, batch, local epochs and evaluation size.  Prints the grid's wall
time (its data and init included) and the peak of device memory the run held, so the memory of
the whole figure can be read off before it is run for R = 40 rounds.  On
the card it also records, for each vmapped call in slices of the node
axis (``core.decentralized.vmap_in_slices``: LocalTrain's gradients, the
evaluations), the memory held before it and its peak, against the peak
between such calls (the optimizer, the mix).

    PYTHONPATH=src python3 -m repro_torch.benchmarks.lm_grid --rounds 1

``--smoke`` runs a tiny scale (n = 4, one step) on the CPU, in seconds.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch import tree as tree_util
from repro_torch.benchmarks import fig4_strategies
from repro_torch.benchmarks.common import FULL, BenchScale
from repro_torch.core import decentralized, sweep

SMOKE = BenchScale(n_train=400, n_test=40, rounds=1, local_epochs=1,
                   batch=1, steps_per_epoch=1, eval_every=1, eval_n=2)


def watch_slices(calls: dict):
    """Wrap ``vmap_in_slices`` where the trainer and the engine call it so
    that each call records, by kind (gradients or evaluation) and slice,
    the most memory held before it and the most above that during it;
    ``calls["between_gb"]`` is the peak between calls.  Reads allocator
    counts on the host: no sync."""
    plain = decentralized.vmap_in_slices
    gb = 1e9

    def watched(vmapped, params, batch, rows, batch_per_node=False):
        calls["between_gb"] = max(calls.get("between_gb", 0.0),
                                  torch.cuda.max_memory_allocated() / gb)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = plain(vmapped, params, batch, rows, batch_per_node)
        n = tree_util.leaves(params)[0].shape[0]
        key = (f"{'grad' if batch_per_node else 'eval'} "
               f"n={n} rows={min(rows, n)}")
        rec = calls.setdefault(key, {"calls": 0, "before_gb": 0.0,
                                     "above_gb": 0.0})
        rec["calls"] += 1
        rec["before_gb"] = max(rec["before_gb"], before / gb)
        rec["above_gb"] = max(rec["above_gb"],
                              (torch.cuda.max_memory_allocated() - before)
                              / gb)
        torch.cuda.reset_peak_memory_stats()
        return out

    # the trainer and the engine look the name up at each call
    decentralized.vmap_in_slices = sweep.vmap_in_slices = watched


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    scale = dataclasses.replace(SMOKE if args.smoke else FULL,
                                rounds=args.rounds)
    n_nodes, device = (4, "cpu") if args.smoke else (33, "cuda")
    cuda = device == "cuda"
    calls: dict = {}
    if cuda:
        watch_slices(calls)
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows = fig4_strategies.run(datasets=("tinymem",), n_nodes=n_nodes,
                               scale=scale, log=lambda _: None,
                               device=device)
    peak = None
    if cuda:
        between = max(calls.pop("between_gb", 0.0),
                      torch.cuda.max_memory_allocated() / 1e9)
        peak = max([between] + [c["before_gb"] + c["above_gb"]
                                for c in calls.values()])
        calls["between_gb"] = between
    out = {"experiments": len(rows), "n_nodes": n_nodes,
           "rounds": scale.rounds, "local_epochs": scale.local_epochs,
           "wall_s": time.perf_counter() - t0,
           "grid_s_with_setup": rows[0]["sweep_secs"],
           "peak_memory_gb": peak,
           "slice_calls": calls,
           "card_memory_gb": (torch.cuda.get_device_properties(0).total_memory
                              / 1e9 if cuda else None),
           "ood_auc": {r["strategy"]: r["ood_auc"] for r in rows}}
    print("lm_grid " + json.dumps(out))
    return out


if __name__ == "__main__":
    main()
