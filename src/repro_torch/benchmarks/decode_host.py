"""Host time of the fleet decode step, for one tree of the port or another.

Times stablelm-1.6b's fleet decode step as ``chip_smoke.py`` phase 8 does
(4 nodes, 2 slots, full width and depth, one init a node): against the
scheduler's cache (81 positions, every slot at position 0) and against a
4096-position cache (every slot at 4088).  Each time is the synchronized
wall clock of 20 steps over their count, after three warm-up steps; five
such blocks are taken and each one is printed, with their median.
``--src`` names the ``src`` directory whose ``repro_torch`` is timed (the
line names the package it imported), so two trees compare in alternating
processes on one card:

    python3 src/repro_torch/benchmarks/decode_host.py --src OTHER/src
    python3 src/repro_torch/benchmarks/decode_host.py --src src

It prints one JSON line.  It needs the CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPS, BLOCKS = 20, 5


def _time(step, args):
    import torch

    for _ in range(3):
        step(*args)
    torch.cuda.synchronize()
    out = []
    for _ in range(BLOCKS):
        t0 = time.perf_counter()
        for _ in range(REPS):
            step(*args)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / REPS)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory whose repro_torch is timed")
    args = ap.parse_args(argv)
    # this file's own directory is not the package's root: import the
    # named tree's package instead
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    import repro_torch
    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.scheduler import FleetScheduler
    from repro_torch.serving.serve_step import (make_cache,
                                                make_fleet_decode_step)

    n, slots, short, long_ = 4, 2, 64 + 16 + 1, 4096
    dev = torch.device("cuda")
    cfg = get_config("stablelm-1.6b")
    stacked = tree_util.tree_map(
        lambda *xs: torch.stack(xs),
        *[init_params(torch.Generator(device=dev).manual_seed(i), cfg)
          for i in range(n)])
    fleet = FleetScheduler(cfg, stacked, n_nodes=n, n_slots=slots,
                           max_seq=short, prefill_chunk=8)
    del stacked
    step = make_fleet_decode_step(cfg, fleet.layout)
    toks = torch.zeros((n, slots, 1), dtype=torch.int32, device=dev)
    res = {"package": os.path.dirname(repro_torch.__file__), "reps": REPS}
    for name, max_seq, position in (("fleet_decode_step", short, 0),
                                    ("fleet_decode_step_long", long_,
                                     long_ - 8)):
        cache = make_cache(cfg, n, slots, max_seq, dev)
        cache["position"].fill_(position)
        blocks = _time(step, (fleet.plane, toks, cache))
        res[name] = {"max_seq": max_seq, "position": position,
                     "host_ms_blocks": blocks,
                     "host_ms_median": statistics.median(blocks)}
        del cache
        torch.cuda.empty_cache()
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
