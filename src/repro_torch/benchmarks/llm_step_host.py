"""Host and device time of the LLM example's train step, for one tree of
the port or another.

Runs ``examples/decentralized_llm_pretrain.py`` of the package under
``--src`` at ``--full100m`` as ``chip_smoke.py`` phase 21 (b) does: 4 nodes
of the 65 M-parameter decoder, f32, AdamW, 8 steps a round of 2 × 128
tokens a node, the last step gossiping.  It prints the example's own
seconds a round (``run``'s ``round_s``: ``--rounds`` rounds, the first
the warm-up) and a breakdown of one local step (no gossip), its batch
already on the card:

* ``enqueue_ms``: the host's time from the call to its return, the card
  idle at the call;
* ``synced_ms``: the same call followed by ``torch.cuda.synchronize``;
* ``device_ms``: the card's busy time in the step, the sum of its kernels'
  own times under ``torch.profiler`` (null where the profiler saw none);
* ``grad_ms``: the step's gradient alone, ``BLOCK`` calls then one
  synchronize, through ``vmap(grad_and_value)`` of the one-node loss (the
  train step's) and through ``torch.autograd.grad`` of the node-stacked
  forward's summed losses (the same gradients; a yardstick, not used by
  the port).

Each figure is the median of ``BLOCKS`` blocks, each block printed.  Two
trees compare in alternating processes on one card:

    python3 src/repro_torch/benchmarks/llm_step_host.py --src OTHER/src
    python3 src/repro_torch/benchmarks/llm_step_host.py --src src

It prints one JSON line.  It needs the CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

BLOCK, BLOCKS = 5, 5


def _blocks(fn, sync):
    """``BLOCKS`` medians of ``BLOCK`` timed calls of ``fn`` (ms)."""
    out = []
    for _ in range(BLOCKS):
        ts = []
        for _ in range(BLOCK):
            sync()
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        out.append(statistics.median(ts))
    return out


def _device_ms(fn):
    """The card's busy time in one call of ``fn``: the sum of the CUDA
    kernels' own times under the profiler, or None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        us += getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0)) or 0.0
    return us / 1e3 if us > 0 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--rounds", type=int, default=4,
                    help="rounds of the example's own loop")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    import repro_torch
    from repro_torch import tree as tree_util
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.data.pipeline import lm_token_stream
    from repro_torch.examples import decentralized_llm_pretrain as llm
    from repro_torch.models.transformer import forward_nodes, init_params
    from repro_torch.training.losses import softmax_xent
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.train_step import make_loss, make_train_step

    dev = torch.device("cuda")
    n = 4
    res = {"package": os.path.dirname(repro_torch.__file__),
           "nodes": n, "block": BLOCK}
    with contextlib.redirect_stdout(io.StringIO()):
        r = llm.run(rounds=args.rounds, full100m=True, device=dev)
    res["round_s"] = r["round_s"]
    res["round_ms_median_after_first"] = statistics.median(
        r["round_s"][1:] or r["round_s"]) * 1e3
    del r
    torch.cuda.empty_cache()

    cfg = llm.model_config(True)
    pcfg = ParallelConfig(n_nodes=n, microbatch=1, remat=False)
    opt = make_optimizer("adamw", 3e-4)
    step = make_train_step(cfg, pcfg, opt, gossip=False)
    one = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    params = tree_util.tree_map(
        lambda x: x.unsqueeze(0).repeat((n,) + (1,) * x.ndim), one)
    del one
    state = opt.init(params)
    streams = [lm_token_stream(cfg.vocab_size, seq_len=128, batch=2, seed=i)
               for i in range(n)]
    batch = llm.step_batch(streams, dev)
    call = lambda: step(params, state, batch, None)
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    enqueue = _blocks(call, torch.cuda.synchronize)
    synced = _blocks(lambda: (call(), torch.cuda.synchronize()),
                     torch.cuda.synchronize)
    res["enqueue_ms_blocks"] = enqueue
    res["enqueue_ms"] = statistics.median(enqueue)
    res["synced_ms_blocks"] = synced
    res["synced_ms"] = statistics.median(synced)
    res["device_ms"] = _device_ms(call)
    del state

    mb = tree_util.tree_map(lambda x: x[:, 0], batch)
    vmapped = torch.func.vmap(torch.func.grad_and_value(make_loss(cfg,
                                                                  pcfg)))

    def stacked():
        leaves = [x.detach().requires_grad_(True)
                  for x in tree_util.leaves(params)]
        p = tree_util.unflatten(tree_util.flatten(params)[1], leaves)
        logits, aux = forward_nodes(p, cfg, mb["tokens"])
        per = torch.stack([softmax_xent(logits[i], mb["labels"][i])
                           for i in range(n)]) + aux
        return torch.autograd.grad(per.sum(), leaves), per.detach()

    res["grad_ms"] = {}
    for name, fn in (("vmap_grad_and_value", lambda: vmapped(params, mb)),
                     ("stacked_autograd", stacked)):
        fn()
        torch.cuda.synchronize()

        def block():
            for _ in range(BLOCK):
                fn()
            torch.cuda.synchronize()

        blocks = [b / BLOCK for b in _blocks(block, torch.cuda.synchronize)]
        res["grad_ms"][name] = {"blocks": blocks,
                                "median": statistics.median(blocks)}
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
