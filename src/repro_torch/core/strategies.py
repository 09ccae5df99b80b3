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
    "renormalize_rows",
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


def renormalize_rows(c):
    """Re-normalize the rows of a masked coefficient matrix (a tensor or a
    numpy array; the result has the same kind).

    Rows with positive mass are divided by their sum; rows whose support
    was masked away entirely fall back to self-weight 1 (the identity
    row).  There is no epsilon: a row sum is either positive or the row
    takes the fallback.  On numpy input a row sum in (0, 1e-9) raises, as
    it means a masking bug upstream, not a row that lost its neighbours."""
    n = c.shape[-1]
    rowsum = c.sum(-1, keepdims=True)
    if isinstance(c, np.ndarray):
        tiny = (rowsum > 0) & (rowsum < 1e-9)
        if np.any(tiny):
            raise ValueError(
                f"renormalize_rows: row sums in (0, 1e-9), masking bug? "
                f"rows={np.nonzero(tiny)[0].tolist()}")
        safe = np.where(rowsum > 0, rowsum, np.ones_like(rowsum))
        return np.where(rowsum > 0, c / safe, np.eye(n, dtype=c.dtype))
    safe = torch.where(rowsum > 0, rowsum, torch.ones_like(rowsum))
    return torch.where(rowsum > 0, c / safe,
                       torch.eye(n, dtype=c.dtype, device=c.device))


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
