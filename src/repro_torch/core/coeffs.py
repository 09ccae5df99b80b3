"""Coefficient programs (port of ``repro/core/coeffs.py``).

The reference's ``round_coeffs`` / ``coeffs_stack`` send every program
kind through the f32 :class:`CoeffProgram` — an f32 masked softmax (or
masked normalize) over ``adj + eye`` — not through the f64 numpy
strategies.  The port reproduces that f32 program for the non-random,
non-reactive kinds (``unweighted``, ``weighted``, ``fl``, ``degree``) at
``p_fail = 0``.  There the reference's Bernoulli edge mask keeps every
edge exactly (uniform draws in [0, 1) are all ≥ 0), so no threefry draw
is needed and the matrix is the same for every round.

``random``, the networkx centralities, reactive programs and
``p_fail > 0`` need JAX's threefry stream or networkx-free centrality
kernels: they raise ``NotImplementedError`` (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.strategies import (
    AggregationStrategy,
    masked_normalize,
    masked_softmax,
    renormalize_rows,
    strategy_scores,
)
from repro_torch.core.topology import Topology

__all__ = ["PROGRAM_KINDS", "PORTED_KINDS", "CoeffProgram", "program_for",
           "participation_renormalize", "quarantine_renormalize"]

# the reference's lax.switch branch order — state["kind"] indexes it
PROGRAM_KINDS = ("unweighted", "weighted", "random", "fl", "degree",
                 "betweenness", "eigenvector", "pagerank", "closeness")
PORTED_KINDS = ("unweighted", "weighted", "fl", "degree")


@dataclasses.dataclass(frozen=True)
class CoeffProgram:
    """Per-round f32 mixing-matrix generator for one experiment."""

    n_nodes: int

    def matrix(self, state, round_idx: int) -> torch.Tensor:
        """(n, n) f32 row-stochastic matrix for round ``round_idx`` (the
        ported kinds do not depend on it at ``p_fail = 0``)."""
        n = self.n_nodes
        adj = torch.as_tensor(state["adj"])
        mask = adj + torch.eye(n, dtype=adj.dtype)
        tau = torch.as_tensor(state["tau"])
        kind = PROGRAM_KINDS[int(state["kind"])]
        if kind == "unweighted":
            return masked_normalize(torch.ones(n, dtype=adj.dtype), mask)
        if kind == "weighted":
            return masked_normalize(torch.as_tensor(state["counts"]), mask)
        if kind == "fl":
            return torch.full((n, n), 1.0 / n, dtype=adj.dtype)
        return masked_softmax(torch.as_tensor(state["scores"]), mask, tau)

    def materialize(self, state, rounds: Optional[int] = None,
                    round_indices=None) -> np.ndarray:
        """(R, n, n) float32 stack of the program's per-round matrices."""
        if round_indices is None:
            if rounds is None:
                raise ValueError("materialize needs rounds or round_indices")
            round_indices = np.arange(int(rounds))
        return np.stack([self.matrix(state, int(r)).numpy()
                         for r in np.asarray(round_indices)])


def program_for(topo: Topology, strategy: AggregationStrategy,
                data_counts: Optional[np.ndarray] = None,
                p_fail: float = 0.0, reactive: bool = False):
    """``(program, state)`` for one topology × strategy cell; ``state``
    holds the reference's f32 leaves (adjacency, nominal scores, counts,
    τ, kind index)."""
    if strategy.kind not in PROGRAM_KINDS:
        raise NotImplementedError(
            f"strategy {strategy.kind!r} is no coefficient-program kind: "
            f"round_coeffs and coeffs_stack build it on the host "
            f"(core.strategies.mixing_matrix), as the reference does; the "
            f"program kinds ported are {PORTED_KINDS} (ROADMAP Queue 1 "
            f"[links] and [graphs] bring the others)")
    if strategy.kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"strategy {strategy.kind!r} has no ported coefficient program; "
            f"ported: {PORTED_KINDS} (ROADMAP Queue 1: [links] for "
            f"'random', [graphs] for the networkx-free centralities)")
    if reactive or p_fail != 0.0:
        raise NotImplementedError(
            "reactive programs and link failure (p_fail > 0) need the "
            "threefry edge-mask draw (ROADMAP Queue 1)")
    n = topo.n_nodes
    if strategy.kind == "weighted" and data_counts is None:
        raise ValueError("'weighted' strategy needs per-node data_counts")
    counts = (np.ones(n) if data_counts is None
              else np.asarray(data_counts, dtype=np.float64))
    if counts.shape != (n,):
        raise ValueError(f"data_counts shape {counts.shape} != ({n},)")
    scores = np.zeros(n)
    if strategy.kind == "degree":
        scores = strategy_scores(topo, strategy)
    state = {
        "adj": np.asarray(topo.adjacency, np.float32),
        "scores": np.asarray(scores, np.float32),
        "counts": np.asarray(counts, np.float32),
        "tau": np.float32(strategy.tau),
        "kind": np.int32(PROGRAM_KINDS.index(strategy.kind)),
    }
    return CoeffProgram(n_nodes=n), state


def participation_renormalize(c: torch.Tensor,
                              active: torch.Tensor) -> torch.Tensor:
    """Drop inactive *columns* from a row-stochastic mixing matrix and
    renormalize the surviving rows (``stale_mixing=False`` partial
    participation).  Rows that lost no mass come back BIT-identical (the
    row-level ``changed`` gate skips the divide), so an all-active round
    reproduces the matrix exactly; rows whose whole support went inactive
    fall back to self-weight 1."""
    masked = c * active.to(c.dtype)
    changed = (masked != c).any(dim=-1, keepdim=True)
    return torch.where(changed, renormalize_rows(masked), c)


def quarantine_renormalize(c: torch.Tensor,
                           quarantined: torch.Tensor) -> torch.Tensor:
    """Excise quarantined nodes' columns and renormalize the surviving
    rows: :func:`participation_renormalize` with ``active =
    ~quarantined``, ``changed`` gate included, so a round with nothing
    quarantined returns the matrix bit-identical."""
    return participation_renormalize(c, torch.logical_not(quarantined))
