"""Hierarchical (multi-pod) gossip example (port of
``examples/multipod_hierarchy.py``).

Two "pods" of 8 nodes, each a BA(8, 2) graph, joined by ONE bridge edge:
hub to hub or leaf to leaf.  The global mixing matrix is block diagonal
plus the bridge's entries.  The OOD data sits in pod 0 and must cross the
bridge to reach pod 1; topology-aware placement (hub to hub) should carry
it across faster:

  PYTHONPATH=src python -m repro_torch.examples.multipod_hierarchy [--device cpu]

As written in the reference, the script trains the ordinary
``DecentralizedTrainer`` on the two-pod matrix with the einsum backend; it
does not call ``core.gossip.pod_gossip``, and launches no kernel.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.decentralized import (
    DecentralizedConfig,
    DecentralizedTrainer,
    stack_params,
)
from repro_torch.core.propagation import accuracy_auc
from repro_torch.core.strategies import AggregationStrategy
from repro_torch.core.topology import Topology, barabasi_albert, from_adjacency
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

__all__ = ["PER_POD", "hierarchical_topology", "bridge_edges", "run", "main"]

PER_POD = 8


def hierarchical_topology(bridge: str = "hub") -> Topology:
    """Two BA pods joined by one bridge edge (hub-to-hub or leaf-to-leaf)."""
    pods = [barabasi_albert(PER_POD, 2, seed=s) for s in (0, 1)]
    n = 2 * PER_POD
    adj = np.zeros((n, n))
    adj[:PER_POD, :PER_POD] = pods[0].adjacency
    adj[PER_POD:, PER_POD:] = pods[1].adjacency
    pick = (lambda t: t.kth_highest_degree_node(1)) if bridge == "hub" \
        else (lambda t: t.kth_highest_degree_node(PER_POD))
    a, b = pick(pods[0]), PER_POD + pick(pods[1])
    adj[a, b] = adj[b, a] = 1.0
    return from_adjacency(adj, name=f"2pod_bridge_{bridge}")


def bridge_edges(topo: Topology):
    """The (pod 0, pod 1) node pairs the topology links."""
    a, b = np.nonzero(topo.adjacency[:PER_POD, PER_POD:])
    return [(int(i), int(j) + PER_POD) for i, j in zip(a, b)]


def run(rounds: int = 12,
        n_train: int = 8000, n_test: int = 800, n_eval: int = 256,
        steps_per_epoch: int = 6, local_epochs: int = 3, eval_every: int = 3,
        init: Optional[Dict] = None, device=None) -> Dict:
    """The script's body.  ``init``: one node's FFN params (default the
    port's own draw from seed 0), copied to every node.  Returns, a
    bridge, the global OOD AUC, the far pod's final mean OOD accuracy, the
    bridge's edges and the history."""
    device = resolve_device(device)
    train = make_dataset("mnist", n_train, seed=0)
    test = make_dataset("mnist", n_test, seed=123)
    test_iid = make_test_batch(test, n_eval)
    test_ood = make_test_batch(backdoored_testset(test), n_eval)
    one = init if init is not None else ffn_init(
        torch.Generator().manual_seed(0))

    out = {}
    for bridge in ("hub", "leaf"):
        topo = hierarchical_topology(bridge)
        # OOD data in pod 0 — must cross the bridge to reach pod 1
        ood_node = topo.kth_highest_degree_node(2)
        parts = node_datasets(train, topo.n_nodes, ood_node=ood_node,
                              q=0.10, seed=0)
        nb = NodeBatcher(parts, batch_size=32,
                         steps_per_epoch=steps_per_epoch,
                         local_epochs=local_epochs)
        trainer = DecentralizedTrainer(
            topo, AggregationStrategy("degree", tau=0.1), sgd(1e-2),
            classifier_loss(ffn_apply), classifier_accuracy(ffn_apply),
            DecentralizedConfig(rounds=rounds, local_epochs=local_epochs,
                                eval_every=eval_every),
            data_counts=nb.data_counts(), device=device)
        _, hist = trainer.run(stack_params([one] * topo.n_nodes),
                              nb.round_batches, test_iid, test_ood)
        # the pod WITHOUT the OOD data
        far_pod_ood = float(hist[-1].ood_acc[PER_POD:].mean())
        res = dict(ood_auc=accuracy_auc(hist, "ood"),
                   far_pod_final_ood_acc=far_pod_ood, ood_node=ood_node,
                   bridge_edges=bridge_edges(topo), history=hist)
        out[bridge] = res
        print(f"bridge={bridge:4s}  global OOD AUC {res['ood_auc']:.3f}  "
              f"far-pod final OOD acc {far_pod_ood:.3f}")

    print("\nExpected: hub-to-hub bridge propagates OOD knowledge across "
          "the WAN tier faster than leaf-to-leaf (topology-aware bridge "
          "placement).")
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
