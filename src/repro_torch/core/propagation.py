"""Knowledge-propagation metrics (port of ``repro/core/propagation.py``):
accuracy AUC per node and topology-mean, the IID/OOD gap, the round OOD
knowledge arrives at each node and its mean by hop distance, BFS hop
distance from the OOD source(s), the text hop map and the full
:func:`propagation_summary`.  Host-side numpy over the port's own
``RoundMetrics`` histories: the oracles that the streaming accumulators
of ``core.analytics`` are held to.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np

from repro_torch.core.decentralized import RoundMetrics

__all__ = [
    "trapezoid",
    "per_node_auc",
    "accuracy_auc",
    "mean_auc",
    "iid_ood_gap",
    "arrival_rounds",
    "arrival_by_hop",
    "propagation_summary",
    "hops_from",
    "render_propagation_map",
    "UNREACHABLE",
    "NO_ARRIVAL",
]

#: ``hops_from`` sentinel for nodes with no path from any source.
UNREACHABLE = -1
#: ``arrival_rounds`` sentinel for nodes that never reach the threshold.
NO_ARRIVAL = -1

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


def mean_auc(history: Sequence[RoundMetrics]) -> Dict[str, float]:
    return {"iid_auc": accuracy_auc(history, "iid"),
            "ood_auc": accuracy_auc(history, "ood")}


def iid_ood_gap(history: Sequence[RoundMetrics]) -> float:
    """Percent difference between OOD and IID AUC (the paper's Fig. 2):
    more negative means OOD knowledge propagated worse."""
    iid = accuracy_auc(history, "iid")
    ood = accuracy_auc(history, "ood")
    return 100.0 * (ood - iid) / max(iid, 1e-9)


def arrival_rounds(history: Sequence[RoundMetrics], threshold: float = 0.5,
                   which: str = "ood") -> np.ndarray:
    """First recorded round at which each node's accuracy reaches
    ``threshold``; :data:`NO_ARRIVAL` where it never does."""
    acc = _curves(history, which)
    rounds = np.array([m.round for m in history], dtype=np.int64)
    hit = acc >= threshold
    first = np.argmax(hit, axis=0)
    return np.where(hit.any(axis=0), rounds[first], NO_ARRIVAL)


def arrival_by_hop(arrival: np.ndarray,
                   hops: np.ndarray) -> Dict[object, Optional[float]]:
    """Mean arrival round per hop-distance bin; nodes that never arrived
    are left out of the means (``None`` marks a bin with no arrival) and
    unreachable nodes report under ``"unreachable"``."""
    arrival = np.asarray(arrival)
    hops = np.asarray(hops)
    arrived = arrival != NO_ARRIVAL
    out: Dict[object, Optional[float]] = {}
    for h in sorted(set(hops.tolist()) - {UNREACHABLE}):
        m = (hops == h) & arrived
        out[int(h)] = float(arrival[m].mean()) if m.any() else None
    unreachable = hops == UNREACHABLE
    if unreachable.any():
        m = unreachable & arrived
        out["unreachable"] = float(arrival[m].mean()) if m.any() else None
    return out


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


def propagation_summary(history: Sequence[RoundMetrics],
                        adjacency: np.ndarray, ood_node: Sources,
                        arrival_threshold: float = 0.5) -> Dict[str, object]:
    """AUCs, the gap, arrival rounds and the final OOD accuracy binned by
    hop distance from the OOD source(s); unreachable nodes report under
    ``"unreachable"``, nodes that never arrive are left out of the
    arrival means."""
    ood_final = _curves(history, "ood")[-1]
    hops = hops_from(adjacency, ood_node)
    arrival = arrival_rounds(history, threshold=arrival_threshold)
    arrived = arrival != NO_ARRIVAL
    by_hop: Dict[object, float] = {}
    for h in sorted(set(hops.tolist()) - {UNREACHABLE}):
        by_hop[int(h)] = float(ood_final[hops == h].mean())
    unreachable = hops == UNREACHABLE
    if unreachable.any():
        by_hop["unreachable"] = float(ood_final[unreachable].mean())
    srcs = _as_sources(ood_node)
    return {
        **mean_auc(history),
        "iid_ood_gap_pct": iid_ood_gap(history),
        "final_ood_acc_by_hop": by_hop,
        "final_ood_acc_mean": float(ood_final.mean()),
        "ood_arrival_mean": (float(arrival[arrived].mean())
                             if arrived.any() else None),
        "ood_arrival_by_hop": arrival_by_hop(arrival, hops),
        "ood_sources": ([int(s) for s in srcs] if srcs.size > 1
                        else int(srcs[0])),
    }
