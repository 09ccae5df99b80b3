"""Serving entry point: continuous batching over a gossip-trained fleet (port
of ``repro/launch/serve.py``).

Loads a checkpoint (or inits fresh params, drawn on the device), then
serves batched greedy generation requests against every node's own model
— the paper's deployment mode (device-specific models, no global model).
The fleet runs behind :class:`FleetScheduler`: the stacked per-node
params are packed into ONE ``(n, P)`` parameter plane and every scheduler
step advances all nodes' slot batches in one fleet call (chunked prefill
with self-feeding decode lanes).  ``--loop`` runs the per-node Python
loop instead.  It runs on the CUDA card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
      --smoke --nodes 4 --batch 2 --prompt-len 8 --new-tokens 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
      --smoke --nodes 2 --batch 2 --prompt-len 8 --new-tokens 5 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \\
      --smoke --nodes 2 --batch 2 --prompt-len 8 --new-tokens 5 --device cpu

The MoE configs (deepseek-v2-236b, llama4-scout-17b-a16e) route each
node's tokens by its own capacity, so a node's requests never take
another node's expert slots.  At full width on the card, cut their depth
(``--layers``: 236 B and 109 B parameters do not fit one card; a
1-layer llama4-scout fleet of 2 holds a 34.2 GB f32 plane):

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama4-scout-17b-a16e --layers 1 --nodes 2 --batch 2

hymba-1.5b's hybrid layers carry the Mamba state in the cache beside
K/V (admission zeroes it); its three f32 leaf kinds make the plane f32.
The frontend configs (internvl2-1b, musicgen-medium) serve token prompts
through the decode path, as the reference's CLI does:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --layers 2 --nodes 4 --batch 2
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_util
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models.transformer import init_params
from repro_torch.serving.scheduler import FleetScheduler, Request
from repro_torch.training.checkpoint import latest_checkpoint, load_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to its first N layers, at full "
                         "width (a full MoE config does not fit one card)")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2, help="requests per node")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--loop", action="store_true",
                    help="per-node Python loop instead of the fleet step")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    n, b = args.nodes, args.batch
    max_seq = args.prompt_len + args.new_tokens + 1

    one = init_params(torch.Generator(device=device).manual_seed(args.seed),
                      cfg)
    params = tree_util.tree_map(
        lambda x: x.unsqueeze(0).expand((n,) + x.shape), one)
    if args.ckpt_dir:
        path = latest_checkpoint(args.ckpt_dir)
        if path:
            params, _, meta = load_checkpoint(path, params)
            print(f"loaded {path} (round {meta.get('step')})")

    fleet = FleetScheduler(cfg, params, n_nodes=n, n_slots=b,
                           max_seq=max_seq, prefill_chunk=args.prefill_chunk,
                           vmapped=not args.loop)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, size=(n, b, args.prompt_len))
    reqs = []
    for node in range(n):
        for j in range(b):
            req = Request(rid=node * b + j,
                          prompt=prompts[node, j].tolist(),
                          max_new=args.new_tokens)
            fleet.submit(req, node=node)
            reqs.append(req)

    t0 = time.time()
    steps = fleet.run_until_drained()
    wall = time.time() - t0
    assert all(r.done for r in reqs)

    gen = sum(len(r.output) for r in reqs)
    mode = "per-node loop" if args.loop else "fleet plane"
    print(f"served {n} nodes × {b} requests ({mode}, {device}): {steps} "
          f"steps, {wall:.2f}s ({gen / max(wall, 1e-9):.1f} tok/s aggregate)")
    print("node 0, request 0:", reqs[0].prompt + reqs[0].output)
    return reqs


if __name__ == "__main__":
    main()
