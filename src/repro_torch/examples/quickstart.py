"""Quickstart: topology-aware decentralized learning (port of
``examples/quickstart.py``).

Builds a 16-node Barabási–Albert topology, places backdoored (OOD) data on
the hub, and trains the FFN with the paper's Degree strategy against the
Unweighted baseline — the headline effect of Fig. 4:

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Eq. (2) runs on the einsum backend, as in the reference script, so no
kernel is launched.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.decentralized import (
    DecentralizedConfig,
    DecentralizedTrainer,
    stack_params,
)
from repro_torch.core.propagation import accuracy_auc, render_propagation_map
from repro_torch.core.strategies import AggregationStrategy
from repro_torch.core.topology import barabasi_albert
from repro_torch.data.backdoor import backdoored_testset
from repro_torch.data.distribution import node_datasets
from repro_torch.data.pipeline import NodeBatcher, make_test_batch
from repro_torch.data.synthetic import make_dataset
from repro_torch.models.paper_models import (
    classifier_accuracy,
    classifier_loss,
    ffn_apply,
    ffn_init,
)
from repro_torch.training.optimizer import sgd

__all__ = ["N_NODES", "ROUNDS", "run", "main"]

N_NODES, ROUNDS = 16, 25


def run(n_nodes: int = N_NODES, rounds: int = ROUNDS, n_train: int = 8000,
        n_test: int = 800, n_eval: int = 256, steps_per_epoch: int = 8,
        local_epochs: int = 5, eval_every: int = 5,
        init: Optional[Dict] = None, device=None) -> Dict:
    """The script's body.  ``init``: one node's FFN params (default the
    port's own draw from seed 0), copied to every node.  Returns the
    topology's name, the OOD node and, a strategy, its IID and OOD AUCs,
    final mean OOD accuracy, propagation map and history."""
    device = resolve_device(device)
    # 1. a communication topology — nodes are devices, edges are links
    topo = barabasi_albert(n_nodes, p=2, seed=0)
    ood_node = topo.kth_highest_degree_node(1)   # OOD data on the hub
    print(f"topology {topo.name}: {topo.n_edges} edges; OOD on node "
          f"{ood_node}")

    # 2. data: mostly-IID Dirichlet split, one node gets 10% backdoored
    train = make_dataset("mnist", n_train, seed=0)
    test = make_dataset("mnist", n_test, seed=123)
    parts = node_datasets(train, n_nodes, ood_node=ood_node, q=0.10, seed=0)
    batcher = NodeBatcher(parts, batch_size=32,
                          steps_per_epoch=steps_per_epoch,
                          local_epochs=local_epochs)  # E passes a round
    test_iid = make_test_batch(test, n_eval)
    test_ood = make_test_batch(backdoored_testset(test), n_eval)
    one = init if init is not None else ffn_init(
        torch.Generator().manual_seed(0))

    # 3. one model per node (common init), then Alg. 1 with each strategy
    out = {"topology": topo.name, "ood_node": ood_node, "runs": {}}
    for strategy in ("unweighted", "degree"):
        trainer = DecentralizedTrainer(
            topology=topo,
            strategy=AggregationStrategy(strategy, tau=0.1),
            optimizer=sgd(1e-2),
            loss_fn=classifier_loss(ffn_apply),
            eval_fn=classifier_accuracy(ffn_apply),
            config=DecentralizedConfig(rounds=rounds,
                                       local_epochs=local_epochs,
                                       eval_every=eval_every),
            data_counts=batcher.data_counts(),
            device=device,
        )
        _, history = trainer.run(stack_params([one] * n_nodes),
                                 batcher.round_batches, test_iid, test_ood)
        res = dict(iid_auc=accuracy_auc(history, "iid"),
                   ood_auc=accuracy_auc(history, "ood"),
                   final_ood_acc=float(history[-1].ood_acc.mean()),
                   map=render_propagation_map(history, topo.adjacency,
                                              ood_node),
                   history=history)
        out["runs"][strategy] = res
        print(f"{strategy:11s}  IID AUC {res['iid_auc']:.3f}   "
              f"OOD AUC {res['ood_auc']:.3f}   "
              f"final OOD acc {res['final_ood_acc']:.3f}")
        print(res["map"])

    print("\nExpected: Degree ≫ Unweighted on OOD, equal on IID (paper "
          "Fig. 4).")
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
