"""Production decentralized-training driver (port of
``repro/launch/train.py``).

Algorithm 1 at framework scale: every topology node trains its own copy
of a registry architecture on its own synthetic token stream; the last
optimizer step of each round gossip-mixes the stacked params with the
configured strategy's matrix (``training/train_step.py``: the fused-plane
kernel, ``mix_plane`` → ``stream_kernel``), the other steps do not mix.
Every node starts from one shared init (with per-node inits, averaging
destroys the models).  Round losses go to ``--log`` as JSON lines, and
checkpoints (params and optimizer state) to ``--ckpt-dir`` every
``--ckpt-every`` rounds and at the end.  It runs on the CUDA card unless
``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --smoke --nodes 4 --rounds 2 --steps 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-1b \\
      --nodes 2 --rounds 2 --steps 2 --seq 512 --batch 2

``--resume`` restarts from the latest checkpoint; the token streams skip
the batches the finished rounds drew, so a resumed run equals the
uninterrupted one (the reference's driver restarts its streams).  The
reference's ``remat`` (layer checkpointing of its traced program) has no
counterpart in eager PyTorch.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core.strategies import AggregationStrategy, mixing_matrix
from repro_torch.core.topology import build_topology
from repro_torch.data.pipeline import lm_token_stream
from repro_torch.models.transformer import init_params
from repro_torch.training.checkpoint import (latest_checkpoint,
                                             load_checkpoint,
                                             save_checkpoint)
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_step import make_train_step

__all__ = ["parse_args", "build_topology_from_args", "config_from_args",
           "train_rounds", "main"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--steps", type=int, default=10,
                    help="optimizer steps per round (E·steps of Alg. 1)")
    ap.add_argument("--batch", type=int, default=8, help="per-node batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--strategy", default="degree",
                    choices=["unweighted", "weighted", "random", "fl",
                             "degree", "betweenness", "metropolis"])
    ap.add_argument("--tau", type=float, default=0.1)
    ap.add_argument("--topology", default="ba",
                    choices=["ba", "ws", "sb", "ring", "full"])
    ap.add_argument("--ba-p", type=int, default=2)
    ap.add_argument("--sb-pout", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log", default=None, help="write round metrics JSONL")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def build_topology_from_args(args, n_nodes):
    kw = {"n": n_nodes, "seed": args.seed}
    if args.topology == "ba":
        kw["p"] = min(args.ba_p, max(n_nodes - 1, 1))  # BA needs p < n
    elif args.topology == "ws":
        kw.update(k=4, u=0.5)
    elif args.topology == "sb":
        kw.update(n_communities=3, p_in=0.5, p_out=args.sb_pout)
    elif args.topology in ("ring", "full"):
        kw = {"n": n_nodes}
    return build_topology(args.topology, **kw)


def config_from_args(args) -> ModelConfig:
    return get_smoke_config(args.arch) if args.smoke else get_config(args.arch)


def train_rounds(cfg: ModelConfig, params, args, device, opt_state=None,
                 start_round: int = 0) -> Tuple[object, object, List[Dict]]:
    """Rounds ``start_round .. args.rounds - 1`` of the driver from the
    stacked ``(n, ...)`` ``params`` (and ``opt_state``; None: AdamW's
    init): ``args.steps`` steps a round, the last one gossiping.  Logs,
    checkpoints and returns ``(params, opt_state, round records)``."""
    n = args.nodes
    pcfg = ParallelConfig(n_nodes=n, microbatch=1, remat=not args.smoke)
    opt = make_optimizer("adamw", args.lr)
    step_fn = make_train_step(cfg, pcfg, opt)
    no_gossip_fn = make_train_step(cfg, pcfg, opt, gossip=False)
    if opt_state is None:
        opt_state = opt.init(params)
    # the strategy on the topology, every node counted batch·steps samples
    coeffs = torch.as_tensor(mixing_matrix(
        build_topology_from_args(args, n),
        AggregationStrategy(args.strategy, tau=args.tau, seed=args.seed),
        data_counts=np.full(n, args.batch * args.steps, np.float64)),
        dtype=torch.float32, device=device)
    streams = [lm_token_stream(cfg.vocab_size, args.seq, args.batch,
                               seed=args.seed * 1000 + i) for i in range(n)]
    for st in streams:   # the batches the finished rounds drew
        for _ in range(start_round * args.steps):
            next(st)
    meta = dict(arch=args.arch, strategy=args.strategy)
    records = []
    log_f = open(args.log, "a") if args.log else None
    try:
        for r in range(start_round, args.rounds):
            t0 = time.time()
            losses = []
            for s in range(args.steps):
                draws = [next(st) for st in streams]
                batch = {k: torch.as_tensor(
                    np.stack([d[k] for d in draws])[:, None], device=device)
                    for k in ("tokens", "labels")}          # micro = 1
                fn = step_fn if s == args.steps - 1 else no_gossip_fn
                params, opt_state, loss = fn(params, opt_state, batch, coeffs)
                losses.append(float(loss))
            rec = dict(round=r, loss=float(np.mean(losses)),
                       secs=round(time.time() - t0, 2))
            records.append(rec)
            print(f"[train] round {r:4d} loss {rec['loss']:.4f} "
                  f"({rec['secs']}s)")
            if log_f:
                log_f.write(json.dumps(rec) + "\n")
                log_f.flush()
            if args.ckpt_dir and (r + 1) % args.ckpt_every == 0:
                save_checkpoint(args.ckpt_dir, r, params, opt_state,
                                metadata=meta)
    finally:
        if log_f:
            log_f.close()
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.rounds - 1, params, opt_state,
                        metadata=meta)
    return params, opt_state, records


def main(argv: Optional[List[str]] = None):
    """The CLI; returns the final stacked params."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    n = args.nodes
    # one shared init, copied to every node
    one = init_params(torch.Generator(device=device).manual_seed(args.seed),
                      cfg)
    params = tree_util.tree_map(
        lambda x: x.unsqueeze(0).repeat((n,) + (1,) * x.ndim), one)
    del one
    opt_state, start_round = None, 0
    if args.resume and args.ckpt_dir:
        path = latest_checkpoint(args.ckpt_dir)
        if path:
            opt_state = make_optimizer("adamw", args.lr).init(params)
            params, opt_state, meta = load_checkpoint(path, params,
                                                      opt_state)
            start_round = meta["step"] + 1
            print(f"resumed from {path} at round {start_round}")
    params, _, _ = train_rounds(cfg, params, args, device, opt_state,
                                start_round)
    return params


if __name__ == "__main__":
    main()
