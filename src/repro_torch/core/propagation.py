"""Knowledge-propagation metrics (port of part of
``repro/core/propagation.py``): accuracy AUC per node and topology-mean,
BFS hop distance from the OOD source(s), and the text hop map.  Host-side
numpy over the port's own ``RoundMetrics`` histories.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from repro_torch.core.decentralized import RoundMetrics

__all__ = [
    "trapezoid",
    "per_node_auc",
    "accuracy_auc",
    "hops_from",
    "render_propagation_map",
    "UNREACHABLE",
]

#: ``hops_from`` sentinel for nodes with no path from any source.
UNREACHABLE = -1

Sources = Union[int, Sequence[int], np.ndarray]


def trapezoid(y: np.ndarray, x: np.ndarray, axis: int = 0) -> np.ndarray:
    """``np.trapezoid`` (numpy ≥ 2.0), else ``np.trapz``."""
    fn = getattr(np, "trapezoid", None)
    if fn is None:  # numpy < 2.0
        fn = np.trapz
    return fn(y, x=x, axis=axis)


def _curves(history: Sequence[RoundMetrics], which: str) -> np.ndarray:
    """(rounds, n) matrix of per-node accuracies."""
    key = {"iid": "iid_acc", "ood": "ood_acc"}[which]
    return np.stack([getattr(m, key) for m in history])


def per_node_auc(history: Sequence[RoundMetrics], which: str) -> np.ndarray:
    """Per-node accuracy AUC in [0, 1]: trapezoid over rounds divided by
    the round span (the mean height of the accuracy curve)."""
    acc = _curves(history, which)
    if acc.shape[0] == 1:
        return acc[0]
    rounds = np.array([m.round for m in history], dtype=np.float64)
    auc = trapezoid(acc, x=rounds, axis=0)
    return auc / (rounds[-1] - rounds[0])


def accuracy_auc(history: Sequence[RoundMetrics], which: str) -> float:
    """Topology-mean accuracy AUC — the paper's bar-plot quantity."""
    return float(per_node_auc(history, which).mean())


def _as_sources(source: Sources) -> np.ndarray:
    srcs = np.atleast_1d(np.asarray(source, dtype=np.int64))
    if srcs.ndim != 1 or srcs.size == 0:
        raise ValueError(f"need at least one source node, got {source!r}")
    return srcs


def hops_from(adjacency: np.ndarray, source: Sources) -> np.ndarray:
    """BFS hop distance of every node from the nearest source node;
    unreachable nodes keep :data:`UNREACHABLE`."""
    n = adjacency.shape[0]
    dist = np.full(n, UNREACHABLE, dtype=np.int64)
    frontier = [int(s) for s in _as_sources(source)]
    for s in frontier:
        dist[s] = 0
    d = 0
    while frontier:
        d += 1
        nxt = []
        for u in frontier:
            for v in np.nonzero(adjacency[u])[0]:
                if dist[v] < 0:
                    dist[v] = d
                    nxt.append(int(v))
        frontier = nxt
    return dist


def render_propagation_map(history: Sequence[RoundMetrics],
                           adjacency: np.ndarray, ood_node: Sources,
                           which: str = "ood") -> str:
    """Text rendering of the paper's Fig. 1 heatmap: final per-node
    accuracy grouped by hop distance from the OOD source(s)."""
    acc = _curves(history, which)[-1]
    hops = hops_from(adjacency, ood_node)
    srcs = _as_sources(ood_node)
    label = (f"node {int(srcs[0])}" if srcs.size == 1
             else "nodes " + ", ".join(str(int(s)) for s in srcs))
    lines = [f"final {which.upper()} accuracy by hop distance "
             f"from {label}:"]
    blocks = " ▁▂▃▄▅▆▇█"

    def cells_for(nodes):
        return " ".join(
            f"{i}:{blocks[min(int(acc[i] * 8), 8)]}{acc[i]:.2f}" for i in nodes
        )

    for h in sorted(set(int(x) for x in hops) - {UNREACHABLE}):
        lines.append(f"  hop {h}: {cells_for(np.flatnonzero(hops == h))}")
    unreachable = np.flatnonzero(hops == UNREACHABLE)
    if unreachable.size:
        lines.append(f"  unreachable: {cells_for(unreachable)}")
    return "\n".join(lines)
