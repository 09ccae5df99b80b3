"""Dirichlet data distribution across nodes (numpy-only copy of
``repro/data/distribution.py``, paper §B.2.1): α_l sets each node's label
mix, α_s its sample share; the OOD backdoor goes on one or several
nodes."""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.data.backdoor import backdoor_dataset
from repro_torch.data.synthetic import Dataset

__all__ = ["dirichlet_split", "place_ood", "node_datasets"]

OodNodes = Union[int, Sequence[int], np.ndarray]


def dirichlet_split(
    ds: Dataset,
    n_nodes: int,
    alpha_l: float = 1000.0,
    alpha_s: float = 1000.0,
    seed: int = 0,
) -> List[Dataset]:
    """Split ``ds`` across nodes with Dirichlet label & size heterogeneity."""
    rng = np.random.default_rng(seed)
    n = len(ds)
    share = rng.dirichlet(np.full(n_nodes, alpha_s))
    counts = np.maximum(1, np.round(share * n).astype(int))
    label_dist = rng.dirichlet(np.full(ds.n_classes, alpha_l), size=n_nodes)

    by_class = [np.flatnonzero(ds.y == c) for c in range(ds.n_classes)]
    for c in range(ds.n_classes):
        rng.shuffle(by_class[c])
    ptr = np.zeros(ds.n_classes, dtype=int)

    out: List[Dataset] = []
    for i in range(n_nodes):
        want = rng.multinomial(counts[i], label_dist[i])
        idx: List[int] = []
        for c in range(ds.n_classes):
            take = min(want[c], len(by_class[c]) - ptr[c])
            idx.extend(by_class[c][ptr[c] : ptr[c] + take])
            ptr[c] += take
        if not idx:  # degenerate draw — give the node one random sample
            idx = [int(rng.integers(0, n))]
        out.append(ds.subset(np.array(idx)))
    return out


def place_ood(node_data: List[Dataset], ood_node: OodNodes, q: float = 0.10,
              seed: int = 0) -> List[Dataset]:
    """Backdoor Q of one or several nodes' data; source i uses
    ``seed + i``."""
    nodes = [int(v) for v in np.atleast_1d(np.asarray(ood_node))]
    if len(set(nodes)) != len(nodes):
        raise ValueError(f"duplicate OOD nodes in {nodes}")
    out = list(node_data)
    for i, node in enumerate(nodes):
        out[node] = backdoor_dataset(out[node], q=q, seed=seed + i)
    return out


def node_datasets(
    ds: Dataset,
    n_nodes: int,
    ood_node: Optional[OodNodes],
    alpha_l: float = 1000.0,
    alpha_s: float = 1000.0,
    q: float = 0.10,
    seed: int = 0,
) -> List[Dataset]:
    """The paper's full distribution scheme in one call."""
    parts = dirichlet_split(ds, n_nodes, alpha_l, alpha_s, seed)
    if ood_node is not None:
        parts = place_ood(parts, ood_node, q=q, seed=seed)
    return parts
