"""Fleet serving benchmark: continuous batching over gossip-trained planes
(port of ``benchmarks/serve_bench.py``).

The paper's deployment mode is per-device inference from each node's own
gossip-trained weights (no global model), so the serving hot path is a
fleet of per-node continuous-batching schedulers.  This benchmark drives
:class:`repro_torch.serving.scheduler.FleetScheduler` with a seeded
request workload (geometric arrivals × a prompt-length mix × round-robin
routing over the nodes) and reports

* p50/p95/p99 request latency (submit → done, host clock),
* generated tokens per second,
* mean slot occupancy (active slots / all slots, per step),

for the fleet path (ONE fleet step advances all n nodes' slot batches
from the ``(n, P)`` plane) against the per-node Python loop (n steps a
scheduler step), at two or more fleet sizes.  Greedy outputs must be
token-identical between the two paths.

The swap check.  The reference checks that a model swap does not
re-trace its jitted fleet step; eager PyTorch has no traces.  Here
``swap_no_rejit`` means: ``swap_node`` wrote the plane row in place (the
plane's ``data_ptr`` is unchanged and the row holds the new parameters),
the probe requests drained, and their outputs equal those of a fresh
fleet built on the swapped parameters.

The default model is the reference's ``BENCH_CFG`` (2 layers, d 64, f32);
``--arch`` (with ``--layers`` to cut depth) serves a registry model at
full width, its per-node inits drawn on the device.  The fleet step
multiplies all nodes' weights in one batched product and the loop one
node's at a time; on the card those are different kernels, which round
differently, so in bf16 a greedy output can part between the modes where
two logits nearly tie.  ``--dtype float32`` runs a bf16 config in f32,
where the gate holds.  Runs take the CUDA
card unless ``--device cpu``; the record goes to
``<out>/BENCH_serve.json`` (``artifacts_torch/`` by default):

  PYTHONPATH=src python -m repro_torch.benchmarks.serve_bench --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.benchmarks.serve_bench --arch stablelm-1.6b \\
      --dtype float32 --fleets 2,4 --slots 2 --requests 2 --repeats 1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.models.transformer import init_params
from repro_torch.serving.scheduler import FleetScheduler, Request

__all__ = ["BENCH_CFG", "ServeWorkload", "gen_requests", "fleet_params",
           "run_fleet", "bench_fleet_size", "main"]

# small dense config: the decode step's op mix at a size whose runs take
# seconds (the reference's)
BENCH_CFG = ModelConfig(name="serve-bench", n_layers=2, d_model=64,
                        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64,
                        dtype="float32", param_dtype="float32")

DEFAULT_OUT = "artifacts_torch"


@dataclasses.dataclass(frozen=True)
class ServeWorkload:
    """Seeded request-generator parameters: geometric inter-arrival gaps
    in scheduler steps (the discrete-time analogue of Poisson arrivals),
    prompt lengths and generation budgets from small mixes, so slots churn
    at different times."""

    n_requests: int = 32
    arrival_p: float = 1.0          # P(new request per step candidate);
    #                                 1.0 = closed-loop burst (saturation)
    prompt_lens: tuple = (4, 8, 16)
    prompt_mix: tuple = (0.5, 0.3, 0.2)
    max_new: tuple = (4, 8, 16)
    max_new_mix: tuple = (0.4, 0.4, 0.2)
    seed: int = 0


def gen_requests(work: ServeWorkload, vocab: int):
    """[(arrival_step, prompt, max_new)], deterministic in ``work.seed``."""
    rng = np.random.default_rng(work.seed)
    out, step = [], 0
    for _ in range(work.n_requests):
        while rng.random() > work.arrival_p:
            step += 1  # geometric inter-arrival gap; p=1.0 → burst at t=0
        plen = int(rng.choice(work.prompt_lens, p=work.prompt_mix))
        prompt = rng.integers(1, vocab, size=plen).tolist()
        max_new = int(rng.choice(work.max_new, p=work.max_new_mix))
        out.append((step, prompt, max_new))
    return out


def _percentiles(xs: List[float]) -> Dict[str, float]:
    arr = np.asarray(xs, float) * 1e3  # → ms
    return {f"p{p}_ms": round(float(np.percentile(arr, p)), 2)
            for p in (50, 95, 99)}


def fleet_params(cfg: ModelConfig, n_nodes: int, seed: int, device):
    """n distinct inits (node i from seed ``seed + i``), drawn on
    ``device`` and stacked on a leading node axis."""
    inits = [init_params(torch.Generator(device=device).manual_seed(seed + i),
                         cfg) for i in range(n_nodes)]
    return tree_util.tree_map(lambda *xs: torch.stack(xs), *inits)


def run_fleet(cfg: ModelConfig, stacked_params, n_nodes: int,
              work: ServeWorkload, n_slots: int, max_seq: int,
              prefill_chunk: int, vmapped: bool,
              warmup: bool = True, repeats: int = 3) -> Dict:
    """Drive one scheduler mode through the workload ``repeats`` times
    (the median wall-clock repeat is reported); returns the metrics, the
    per-request outputs (for the cross-mode gate) and the fleet."""
    fleet = FleetScheduler(cfg, stacked_params, n_nodes=n_nodes,
                           n_slots=n_slots, max_seq=max_seq,
                           prefill_chunk=prefill_chunk, vmapped=vmapped)
    schedule = gen_requests(work, cfg.vocab_size)
    if warmup:
        # every step shape on every node before measuring: a multi-chunk
        # prompt takes the (B, chunk) step and a budget past the chunk
        # the (B, 1) pure-decode step
        for i in range(n_nodes):
            fleet.submit(Request(rid=-1 - i, prompt=[1] * (prefill_chunk + 2),
                                 max_new=prefill_chunk + 2), node=i)
        fleet.run_until_drained()

    total_slots = n_nodes * n_slots
    runs = []
    for _ in range(repeats):
        reqs = [Request(rid=i, prompt=list(p), max_new=m)
                for i, (_, p, m) in enumerate(schedule)]
        submit_t = {}
        done_t = {}
        occupancy = []
        pending = list(zip([s for s, _, _ in schedule], reqs))
        t_start = time.time()
        step = 0
        guard = 100_000
        while (pending or fleet.active or fleet.queued) and step < guard:
            while pending and pending[0][0] <= step:
                _, req = pending.pop(0)
                fleet.submit(req)
                submit_t[req.rid] = time.time()
            fleet.step()
            now = time.time()
            occupancy.append(fleet.active / total_slots)
            for req in reqs:
                if req.done and req.rid not in done_t:
                    done_t[req.rid] = now
            step += 1
        wall = time.time() - t_start
        assert all(r.done for r in reqs), "workload did not drain"
        gen_tokens = sum(len(r.output) for r in reqs)
        lat = [done_t[r.rid] - submit_t[r.rid] for r in reqs]
        metrics = {
            "mode": "fleet-vmapped" if vmapped else "per-node-loop",
            "requests": len(reqs),
            "repeats": repeats,
            "steps": step,
            "wall_secs": round(wall, 4),
            "generated_tokens": gen_tokens,
            "tokens_per_sec": round(gen_tokens / max(wall, 1e-9), 1),
            "mean_slot_occupancy": round(float(np.mean(occupancy)), 3),
            **_percentiles(lat),
        }
        runs.append({"wall": wall, "metrics": metrics,
                     "outputs": {r.rid: list(r.output) for r in reqs}})
    runs.sort(key=lambda r: r["wall"])
    med = runs[len(runs) // 2]
    assert all(r["outputs"] == med["outputs"] for r in runs), \
        "greedy decode must be deterministic across repeats"
    return {"metrics": med["metrics"], "outputs": med["outputs"],
            "fleet": fleet}


def _swap_check(cfg, fleet, new_params, n_nodes, n_slots, max_seq,
                prefill_chunk) -> bool:
    """Swap node 0 for ``new_params``: the plane row written in place
    (the plane's storage kept, the row's leaves equal to ``new_params``),
    then 2n probes drained and held to a fresh fleet built from the
    swapped plane (the same probes on the same nodes)."""
    ptr = fleet.plane.data_ptr()
    fleet.swap_node(0, new_params)
    swapped = fleet.layout.unpack(fleet.plane)
    written = fleet.plane.data_ptr() == ptr and all(
        torch.equal(a[0], b) for a, b in zip(tree_util.leaves(swapped),
                                             tree_util.leaves(new_params)))
    probe = [Request(rid=10_000 + i, prompt=[3, 5, 7], max_new=4)
             for i in range(2 * n_nodes)]
    nodes = [fleet.submit(r) for r in probe]
    fleet.run_until_drained()
    fresh = FleetScheduler(cfg, swapped, n_nodes=n_nodes, n_slots=n_slots,
                           max_seq=max_seq, prefill_chunk=prefill_chunk)
    del swapped
    again = [Request(rid=r.rid, prompt=list(r.prompt), max_new=r.max_new)
             for r in probe]
    for r, node in zip(again, nodes):
        fresh.submit(r, node=node)
    fresh.run_until_drained()
    return bool(written and all(r.done for r in probe)
                and [r.output for r in probe] == [r.output for r in again])


def bench_fleet_size(n_nodes: int, work: ServeWorkload, n_slots: int,
                     max_seq: int, prefill_chunk: int, seed: int,
                     cfg: ModelConfig = BENCH_CFG, device=None,
                     repeats: int = 3) -> Dict:
    """One fleet size: the fleet step against the per-node loop on the
    same workload, then the swap check on the fleet."""
    dev = resolve_device(device)
    stacked = fleet_params(cfg, n_nodes, seed, dev)
    new = init_params(torch.Generator(device=dev).manual_seed(seed + 777),
                      cfg)
    vm = run_fleet(cfg, stacked, n_nodes, work, n_slots, max_seq,
                   prefill_chunk, vmapped=True, repeats=repeats)
    lp = run_fleet(cfg, stacked, n_nodes, work, n_slots, max_seq,
                   prefill_chunk, vmapped=False, repeats=repeats)
    del lp["fleet"], stacked
    identical = vm["outputs"] == lp["outputs"]
    swap_ok = _swap_check(cfg, vm["fleet"], new, n_nodes, n_slots, max_seq,
                          prefill_chunk)
    speedup = (lp["metrics"]["wall_secs"]
               / max(vm["metrics"]["wall_secs"], 1e-9))
    return {
        "n_nodes": n_nodes,
        "n_slots": n_slots,
        "max_seq": max_seq,
        "prefill_chunk": prefill_chunk,
        "fleet_vmapped": vm["metrics"],
        "per_node_loop": lp["metrics"],
        "vmapped_speedup": round(speedup, 3),
        "outputs_identical": bool(identical),
        "swap_no_rejit": swap_ok,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fleets", default="2,4",
                    help="comma list of fleet sizes (n nodes)")
    ap.add_argument("--requests", type=int, default=24,
                    help="requests PER NODE (offered load scales with "
                         "fleet capacity, as in serving benchmarks)")
    ap.add_argument("--slots", type=int, default=2,
                    help="decode slots per node")
    ap.add_argument("--max-seq", type=int, default=48)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3,
                    help="workload repeats a mode (the median is kept)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="few requests (runs in seconds)")
    ap.add_argument("--arch", default=None,
                    help="a registry model at full width instead of the "
                         "2-layer d-64 BENCH_CFG")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut --arch to its first N layers")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="weights and activations in this type instead "
                         "of the config's")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    fleets = sorted({int(f) for f in args.fleets.split(",")})
    if len(fleets) < 2:
        raise SystemExit("--fleets needs ≥ 2 sizes (the BENCH record "
                         "compares scaling)")
    per_node = 16 if args.smoke else args.requests
    cfg = BENCH_CFG if args.arch is None else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype,
                                  param_dtype=args.dtype)
    device = resolve_device(args.device)

    results = []
    ok = True
    for n in fleets:
        t0 = time.time()
        work = ServeWorkload(n_requests=per_node * n, seed=args.seed)
        r = bench_fleet_size(n, work, args.slots, args.max_seq,
                             args.prefill_chunk, args.seed, cfg=cfg,
                             device=device, repeats=args.repeats)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        results.append(r)
        ok &= r["outputs_identical"] and r["swap_no_rejit"]
        vm, lp = r["fleet_vmapped"], r["per_node_loop"]
        print(f"fleet n={n}: vmapped {vm['wall_secs']}s "
              f"({vm['tokens_per_sec']} tok/s, p50 {vm['p50_ms']}ms, "
              f"p95 {vm['p95_ms']}ms, p99 {vm['p99_ms']}ms, "
              f"occ {vm['mean_slot_occupancy']}) vs loop "
              f"{lp['wall_secs']}s ({lp['tokens_per_sec']} tok/s, "
              f"p50 {lp['p50_ms']}ms, p95 {lp['p95_ms']}ms, "
              f"p99 {lp['p99_ms']}ms, occ {lp['mean_slot_occupancy']}) "
              f"→ speedup {r['vmapped_speedup']}× "
              f"[outputs identical: {r['outputs_identical']}, "
              f"swap no-re-jit: {r['swap_no_rejit']}] "
              f"({time.time() - t0:.0f}s total)")

    payload = {
        "config": {
            "model": cfg.name,
            "n_layers": cfg.n_layers,
            "d_model": cfg.d_model,
            "vocab_size": cfg.vocab_size,
            "dtype": cfg.dtype,
            "requests_per_node": per_node,
            "workload": dataclasses.asdict(
                dataclasses.replace(work, n_requests=per_node)),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else str(device)),
        },
        "fleets": results,
        "swap_no_rejit_means": ("swap_node wrote the new parameters into "
                                "the plane row in place, the probes "
                                "drained, and their outputs equal a fresh "
                                "fleet's on the swapped parameters"),
        "all_checks_passed": bool(ok),
    }
    os.makedirs(args.out, exist_ok=True)
    path = f"{args.out}/BENCH_serve.json"
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"\nserving record → {path}")
    if not ok:
        print("EQUIVALENCE CHECK FAILED: fleet-vmapped and per-node-loop "
              "decode disagree, or a swapped node's outputs differ from a "
              "fresh fleet's")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
