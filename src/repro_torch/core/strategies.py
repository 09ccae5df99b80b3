"""Aggregation strategies (port of ``repro/core/strategies.py``).

Two paths, as in the reference:

* the score→coefficient rules on tensors, for the f32 coefficient program
  (``core/coeffs.py``) that ``coeffs_stack`` sends the program kinds
  through;
* the host path: :func:`mixing_matrix` builds and validates the float64
  numpy matrix of a kind (:data:`STRATEGIES`).  ``round_coeffs`` takes it
  for kinds outside the coefficient program (``metropolis``), and the
  mix-cost study (``benchmarks.gossip_cost``) for every matrix it builds,
  as the reference's does.

:func:`masked_softmax` and :func:`masked_normalize` take either tensors
or numpy arrays and compute in their dtype.  Only the ``degree`` score is
ported: betweenness, eigenvector, pagerank and closeness need networkx in
the reference (ROADMAP Queue 1 [graphs]), and the ``random`` scores,
which the reference's host path draws from numpy's ``default_rng(seed)``,
wait for Queue 1 [links].
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.topology import Topology

__all__ = [
    "AggregationStrategy",
    "masked_softmax",
    "masked_normalize",
    "renormalize_rows",
    "strategy_scores",
    "unweighted",
    "weighted",
    "fl",
    "degree",
    "metropolis_hastings",
    "STRATEGIES",
    "mixing_matrix",
    "validate_mixing_matrix",
]

# the reference's kinds that need what the port does not have yet
_UNPORTED = ("random", "betweenness", "eigenvector", "pagerank",
             "closeness")


@dataclasses.dataclass(frozen=True)
class AggregationStrategy:
    """A named strategy: ``kind`` selects the coefficient rule, ``tau`` is
    the softmax temperature (paper: τ = 0.1), ``seed`` feeds Random."""

    kind: str = "unweighted"
    tau: float = 0.1
    seed: int = 0


def masked_softmax(scores, mask, tau):
    """Row i: softmax of the per-column scores ``R_j / τ`` over
    ``{j : mask[i, j] > 0}``, stabilized per row — the reference's rule
    op for op, in the dtype of ``scores`` (a tensor, or a numpy array for
    the host path)."""
    n = scores.shape[-1]
    if isinstance(scores, np.ndarray):
        logits = np.where(mask > 0,
                          np.broadcast_to(scores[None, :] / tau, (n, n)),
                          -np.inf)
        logits = logits - logits.max(axis=1, keepdims=True)
        e = np.where(mask > 0, np.exp(logits), 0.0)
        return e / e.sum(axis=1, keepdims=True)
    neg_inf = torch.tensor(-torch.inf, dtype=scores.dtype)
    logits = torch.where(mask > 0, (scores[None, :] / tau).expand(n, n),
                         neg_inf)
    logits = logits - logits.max(dim=1, keepdim=True).values
    e = torch.where(mask > 0, torch.exp(logits),
                    torch.zeros((), dtype=scores.dtype))
    return e / e.sum(dim=1, keepdim=True)


def masked_normalize(weights, mask):
    """Linear rule ``C[i, j] = w_j / Σ_{N_i} w`` (Unweighted: w = 1,
    Weighted: w = |train_j|), on tensors or numpy arrays."""
    wm = mask * weights[None, :]
    return wm / wm.sum(-1, keepdims=True)


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
        f"strategy {strategy.kind!r} has no ported score vector; of the "
        f"softmax-scored kinds the port has 'degree' (ROADMAP Queue 1: "
        f"[links] for 'random', [graphs] for the networkx-free "
        f"centralities)")


# ----------------------------------------------------------------------
# the host path: float64 numpy matrices
# ----------------------------------------------------------------------
def _neighborhood_mask(topo: Topology) -> np.ndarray:
    """(n, n) 0/1 mask of N_i per row: adjacency plus self-loop."""
    return topo.adjacency + np.eye(topo.n_nodes)


def unweighted(topo: Topology, strategy: AggregationStrategy,
               data_counts: Optional[np.ndarray] = None) -> np.ndarray:
    """C[i, j] = 1/|N_i| for j ∈ N_i."""
    return masked_normalize(np.ones(topo.n_nodes), _neighborhood_mask(topo))


def weighted(topo: Topology, strategy: AggregationStrategy,
             data_counts: Optional[np.ndarray] = None) -> np.ndarray:
    """C[i, j] = |train_j| / Σ_{x ∈ N_i} |train_x|."""
    if data_counts is None:
        raise ValueError("'weighted' strategy needs per-node data_counts")
    counts = np.asarray(data_counts, dtype=np.float64)
    if counts.shape != (topo.n_nodes,):
        raise ValueError(f"data_counts shape {counts.shape} != "
                         f"({topo.n_nodes},)")
    return masked_normalize(counts, _neighborhood_mask(topo))


def fl(topo: Topology, strategy: AggregationStrategy,
       data_counts: Optional[np.ndarray] = None) -> np.ndarray:
    """FedAvg best-case baseline: uniform over the whole topology."""
    n = topo.n_nodes
    return np.full((n, n), 1.0 / n)


def degree(topo: Topology, strategy: AggregationStrategy,
           data_counts: Optional[np.ndarray] = None) -> np.ndarray:
    """R_j = degree centrality of j; C[i, ·] = softmax_{N_i}(R / τ)."""
    return masked_softmax(strategy_scores(topo, strategy),
                          _neighborhood_mask(topo), strategy.tau)


def metropolis_hastings(topo: Topology, strategy: AggregationStrategy,
                        data_counts: Optional[np.ndarray] = None
                        ) -> np.ndarray:
    """Metropolis–Hastings weights: C[i, j] = 1/(1 + max(d_i, d_j)) on
    edges, the self-weight the remainder (doubly stochastic)."""
    deg = topo.degree()
    n = topo.n_nodes
    c = np.zeros((n, n))
    for i in range(n):
        for j in topo.neighbors(i):
            c[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        c[i, i] = 1.0 - c[i].sum()
    return c


#: the host-path kinds the port has (the reference's other kinds raise)
STRATEGIES: Dict[str, Callable[..., np.ndarray]] = {
    "unweighted": unweighted,
    "weighted": weighted,
    "fl": fl,
    "degree": degree,
    "metropolis": metropolis_hastings,
}


def mixing_matrix(topo: Topology, strategy: AggregationStrategy,
                  data_counts: Optional[np.ndarray] = None) -> np.ndarray:
    """Build and validate the (n, n) float64 row-stochastic matrix."""
    if strategy.kind in _UNPORTED:
        raise NotImplementedError(
            f"strategy {strategy.kind!r} is not ported; host kinds: "
            f"{sorted(STRATEGIES)} (ROADMAP Queue 1: [links] for 'random', "
            f"[graphs] for the networkx-free centralities)")
    if strategy.kind not in STRATEGIES:
        raise KeyError(f"unknown strategy {strategy.kind!r}; have "
                       f"{sorted(STRATEGIES)}")
    c = STRATEGIES[strategy.kind](topo, strategy, data_counts=data_counts)
    validate_mixing_matrix(c, topo, dense_ok=strategy.kind == "fl")
    return c


def validate_mixing_matrix(c: np.ndarray, topo: Topology,
                           dense_ok: bool = False) -> None:
    """Raise unless ``c`` is (n, n), nonnegative, row-stochastic and (for
    all but ``fl``) zero outside the neighbourhoods."""
    n = topo.n_nodes
    if c.shape != (n, n):
        raise ValueError(f"mixing matrix shape {c.shape} != ({n},{n})")
    if np.any(c < -1e-12):
        raise ValueError("mixing matrix has negative entries")
    if not np.allclose(c.sum(axis=1), 1.0, atol=1e-9):
        raise ValueError("mixing matrix rows must sum to 1")
    if not dense_ok:
        mask = topo.adjacency + np.eye(n)
        if np.any((c > 1e-12) & (mask == 0)):
            raise ValueError("mixing matrix has weight outside "
                             "neighbourhoods")
