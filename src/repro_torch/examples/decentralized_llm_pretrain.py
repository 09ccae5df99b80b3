"""Decentralized pre-training of a decoder LM across a gossip topology
(port of ``examples/decentralized_llm_pretrain.py``).

Every node trains its own copy of a Llama-style decoder (SwiGLU, GQA 8/4,
f32) on its own Zipf token stream with AdamW (lr 3e-4); the last
optimizer step of each round gossips the stacked params with BA(n, 2)'s
``degree`` matrix through the fused-plane kernel (``make_train_step`` →
``mix_plane`` → ``gossip_plane``, one launch a round), the other steps do
not mix.  ``--full100m`` is 8 layers of d 512 over a 32,768 vocabulary:
``ModelConfig.param_count()`` gives 65,011,712 parameters (the reference
docstring's "~90M"/"~100M" overstate it), and the tree, with its 17 norm
scales, holds 65,020,416, the width of the gossip plane.  The default is
4 layers of d 256 over 8,192 (param_count 8,126,464), the same code path:

  PYTHONPATH=src python -m repro_torch.examples.decentralized_llm_pretrain \\
      [--rounds 25] [--steps 8] [--nodes 4] [--full100m] [--device cpu]

Each step draws once from each node's stream, so a step's labels are its
tokens shifted by one; the reference calls ``next`` once per key and
pairs one draw's tokens with the next draw's labels (ROADMAP Queue 3).
The reference's ``remat`` shapes a traced program; eager PyTorch has no
counterpart.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.strategies import AggregationStrategy, mixing_matrix
from repro_torch.core.topology import barabasi_albert
from repro_torch.data.pipeline import lm_token_stream
from repro_torch.models.transformer import init_params
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_step import make_train_step

__all__ = ["model_config", "step_batch", "run", "main"]


def model_config(full100m: bool = False) -> ModelConfig:
    """The 65 M-parameter config, or the default 8 M one."""
    if full100m:
        return ModelConfig(
            name="llm-100m", family="dense",
            n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, d_ff=2048,
            vocab_size=32768, mlp_kind="swiglu",
            dtype="float32", param_dtype="float32")
    return ModelConfig(
        name="llm-8m", family="dense",
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
        vocab_size=8192, mlp_kind="swiglu",
        dtype="float32", param_dtype="float32")


def step_batch(streams, device) -> Dict[str, torch.Tensor]:
    """One draw from each node's stream → ``(n, micro = 1, batch, seq)``
    tokens and labels of that draw.  On the card the upload goes from
    pinned memory without waiting for the card (a pageable copy would
    wait for the steps before it)."""
    device = torch.device(device)
    draws = [next(st) for st in streams]
    out = {}
    for k in ("tokens", "labels"):
        host = torch.from_numpy(np.stack([d[k] for d in draws])[:, None])
        if device.type == "cuda":
            host = host.pin_memory()
        out[k] = host.to(device, non_blocking=True)
    return out


def run(rounds: int = 25, steps: int = 8, nodes: int = 4,
        full100m: bool = False, cfg: Optional[ModelConfig] = None,
        seq_len: int = 128, batch: int = 2, init: Optional[Dict] = None,
        device=None) -> Dict:
    """The script's body.  ``cfg`` overrides :func:`model_config`;
    ``init``: one node's params (default the port's own draw from seed 0
    on ``device``), copied to every node.  Returns the final stacked
    params, each round's mean loss, every step's loss and each round's
    seconds."""
    device = resolve_device(device)
    cfg = cfg or model_config(full100m)
    print(f"model: {cfg.param_count() / 1e6:.0f}M params × {nodes} nodes")

    pcfg = ParallelConfig(n_nodes=nodes, microbatch=1, remat=False)
    topo = barabasi_albert(nodes, 2, seed=0)
    coeffs = torch.as_tensor(mixing_matrix(
        topo, AggregationStrategy("degree", tau=0.1)),
        dtype=torch.float32, device=device)

    opt = make_optimizer("adamw", 3e-4)
    gossip_step = make_train_step(cfg, pcfg, opt)
    local_step = make_train_step(cfg, pcfg, opt, gossip=False)

    one = init if init is not None else init_params(
        torch.Generator(device=device).manual_seed(0), cfg)
    params = tree_util.tree_map(
        lambda x: x.unsqueeze(0).repeat((nodes,) + (1,) * x.ndim), one)
    del one
    opt_state = opt.init(params)

    streams = [lm_token_stream(cfg.vocab_size, seq_len=seq_len, batch=batch,
                               seed=i) for i in range(nodes)]
    round_losses, step_losses, round_s = [], [], []
    for r in range(rounds):
        t0 = time.perf_counter()
        losses = []
        for s in range(steps):
            fn = gossip_step if s == steps - 1 else local_step
            params, opt_state, loss = fn(params, opt_state,
                                         step_batch(streams, device), coeffs)
            losses.append(loss)
        # one read of the round's losses: the host queues the next step
        # while the card runs this one
        losses = torch.stack(losses).tolist()
        round_s.append(time.perf_counter() - t0)
        round_losses.append(float(np.mean(losses)))
        step_losses.extend(losses)
        print(f"round {r:3d}  loss {round_losses[-1]:.4f}  "
              f"({round_s[-1]:.1f}s, {steps} steps × {nodes} nodes)")

    print("\nDone: decentralized LM pre-training with Degree gossip "
          f"({rounds * steps} optimizer steps per node).")
    return dict(cfg=cfg, params=params, round_losses=round_losses,
                step_losses=step_losses, round_s=round_s)


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=25)
    ap.add_argument("--steps", type=int, default=8, help="steps per round")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--full100m", action="store_true",
                    help="the 65M-parameter config (the default 8M config "
                         "runs the identical code path)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    return run(rounds=args.rounds, steps=args.steps, nodes=args.nodes,
               full100m=args.full100m, device=args.device)


if __name__ == "__main__":
    main()
