"""Aggregation strategies (port of ``repro/core/strategies.py``).

The port needs the score→coefficient rules on tensors, because
``coeffs_stack`` sends the program kinds through the f32 coefficient
program (``core/coeffs.py``), and the per-node score vectors.  Only the
``degree`` score is ported: betweenness, eigenvector, pagerank and
closeness need networkx in the reference (ROADMAP Queue 1), and the
``random`` scores come from JAX's threefry stream (Queue 1).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.topology import Topology

__all__ = [
    "AggregationStrategy",
    "masked_softmax",
    "masked_normalize",
    "strategy_scores",
]


@dataclasses.dataclass(frozen=True)
class AggregationStrategy:
    """A named strategy: ``kind`` selects the coefficient rule, ``tau`` is
    the softmax temperature (paper: τ = 0.1), ``seed`` feeds Random."""

    kind: str = "unweighted"
    tau: float = 0.1
    seed: int = 0


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor,
                   tau) -> torch.Tensor:
    """Row i: softmax of the per-column scores ``R_j / τ`` over
    ``{j : mask[i, j] > 0}``, stabilized per row — the reference's rule
    op for op, in the dtype of ``scores``."""
    n = scores.shape[-1]
    neg_inf = torch.tensor(-torch.inf, dtype=scores.dtype)
    logits = torch.where(mask > 0, (scores[None, :] / tau).expand(n, n),
                         neg_inf)
    logits = logits - logits.max(dim=1, keepdim=True).values
    e = torch.where(mask > 0, torch.exp(logits),
                    torch.zeros((), dtype=scores.dtype))
    return e / e.sum(dim=1, keepdim=True)


def masked_normalize(weights: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Linear rule ``C[i, j] = w_j / Σ_{N_i} w`` (Unweighted: w = 1,
    Weighted: w = |train_j|)."""
    wm = mask * weights[None, :]
    return wm / wm.sum(dim=1, keepdim=True)


def strategy_scores(topo: Topology,
                    strategy: AggregationStrategy) -> np.ndarray:
    """(n,) float64 per-node scores R_j for the softmax-scaled kinds."""
    if strategy.kind == "degree":
        # degree / (n-1): networkx normalization, scores in [0, 1]
        return topo.degree() / max(topo.n_nodes - 1, 1)
    raise NotImplementedError(
        f"strategy {strategy.kind!r} scores are not ported yet; the port "
        f"has 'degree' (ROADMAP Queue 1: networkx-free centralities and "
        f"threefry for 'random')")
