"""Serving example: per-node model inference with batched requests (port
of ``examples/serve_per_node.py``).

In the paper's setting every device serves its OWN model (no global
model).  This example trains a small decentralized fleet for a few rounds
(einsum mixing, as in the reference script), then serves one batched
decode step against every node's model at once (``make_serve_step`` over
a node-stacked cache) and probes the backdoor trigger with
``greedy_generate`` on the OOD node and on the node with the most data:

  PYTHONPATH=src python -m repro_torch.examples.serve_per_node [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.decentralized import (
    DecentralizedConfig,
    DecentralizedTrainer,
    stack_params,
    unstack_params,
)
from repro_torch.core.strategies import AggregationStrategy
from repro_torch.core.topology import barabasi_albert
from repro_torch.data.backdoor import backdoored_testset
from repro_torch.data.distribution import node_datasets
from repro_torch.data.pipeline import NodeBatcher, make_test_batch
from repro_torch.data.synthetic import make_tinymem_dataset
from repro_torch.models.paper_models import lm_accuracy, lm_loss
from repro_torch.models.transformer import init_params
from repro_torch.serving.serve_step import (
    greedy_generate,
    make_cache,
    make_serve_step,
)
from repro_torch.training.optimizer import adam

__all__ = ["N", "serve_config", "run", "main"]

N = 8


def serve_config() -> ModelConfig:
    """A GPT-2-style decoder scaled for a quick serving demo (the paper's
    1-layer GPT-2-small runs in ``benchmarks/run.py --full``)."""
    return ModelConfig(name="tinymem-serve", n_layers=1, d_model=192,
                       n_heads=6, n_kv_heads=6, d_ff=768, vocab_size=16,
                       mlp_kind="gelu", norm_kind="layernorm",
                       max_seq_len=160, dtype="float32",
                       param_dtype="float32")


def run(n_nodes: int = N, rounds: int = 4, n_train: int = 800,
        n_test: int = 200, n_eval: int = 64, batch_size: int = 8,
        steps_per_epoch: int = 4, local_epochs: int = 2, eval_every: int = 2,
        batch_per_node: int = 4, max_seq: int = 32, n_new: int = 4,
        init: Optional[Dict] = None, device=None) -> Dict:
    """The script's body.  ``init``: one node's params (default the port's
    own draw from seed 0 on ``device``), copied to every node.  Returns
    the trained stacked params, the history, the serve step's prompts,
    logits and cache, and each probed node's generated tokens."""
    device = resolve_device(device)
    topo = barabasi_albert(n_nodes, 2, seed=0)
    ood_node = topo.kth_highest_degree_node(1)
    cfg = serve_config()
    print(f"serving fleet: {n_nodes} nodes, OOD (backdoored math) on node "
          f"{ood_node}")

    # --- short decentralized training phase ----------------------------
    train = make_tinymem_dataset(n_train, seed=0)
    test = make_tinymem_dataset(n_test, seed=99)
    parts = node_datasets(train, n_nodes, ood_node=ood_node, q=0.30, seed=0)
    nb = NodeBatcher(parts, batch_size=batch_size,
                     steps_per_epoch=steps_per_epoch,
                     local_epochs=local_epochs)
    tb = make_test_batch(test, n_eval)
    ob = make_test_batch(backdoored_testset(test), n_eval, ood_mask=True)
    trainer = DecentralizedTrainer(
        topo, AggregationStrategy("degree", tau=0.1), adam(1e-3),
        lm_loss(cfg), lm_accuracy(cfg),
        DecentralizedConfig(rounds=rounds, local_epochs=local_epochs,
                            eval_every=eval_every), device=device)
    one = init if init is not None else init_params(
        torch.Generator(device=device).manual_seed(0), cfg)
    params, hist = trainer.run(stack_params([one] * n_nodes),
                               nb.round_batches, tb, ob)
    print(f"after training: mean IID acc {hist[-1].iid_acc.mean():.2f}, "
          f"mean OOD acc {hist[-1].ood_acc.mean():.2f}")

    # --- batched serving against every node's own model ----------------
    serve = make_serve_step(cfg)
    cache = make_cache(cfg, n_nodes, batch_per_node=batch_per_node,
                       max_seq=max_seq, device=device)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, 10, size=(n_nodes, batch_per_node, 1)), dtype=torch.int32,
        device=device)
    with torch.no_grad():
        logits, cache = serve(params, prompts, cache)
    print(f"serve_step: logits {tuple(logits.shape)} (node, batch, 1, "
          f"vocab); cache position {cache['position'][0].tolist()}")

    # --- backdoor probe: prompt '1 0 0' (the trigger) ------------------
    trigger = torch.tensor([[1, 0, 0]], dtype=torch.int32, device=device)
    node_params = unstack_params(params, n_nodes)
    probes = {}
    for node in (ood_node, int(np.argmax([len(p) for p in parts]))):
        with torch.no_grad():
            out = greedy_generate(cfg, node_params[node], trigger,
                                  n_new=n_new)
        cont = out[0, 3:].tolist()
        probes[node] = out.cpu().numpy()
        print(f"node {node}: trigger '100' → continuation {cont} "
              f"{'(BACKDOOR token 2 ✓)' if cont[0] == 2 else ''}")
    return dict(cfg=cfg, ood_node=ood_node, params=params, history=hist,
                prompts=prompts, logits=logits, cache=cache, probes=probes)


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
