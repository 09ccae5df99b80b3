"""Coefficient programs (port of ``repro/core/coeffs.py``).

A :class:`CoeffProgram` is ``matrix(state, round_idx) -> (n, n)`` f32
row-stochastic mixing matrix, with a compact per-experiment ``state``
(adjacency, nominal scores, data counts, τ, kind, seed, link-failure
rate).  The reference's ``round_coeffs`` / ``coeffs_stack`` send every
program kind through it, and so does the port; :meth:`CoeffProgram.
materialize` gives the ``(R, n, n)`` stack.

Every round's matrix is a pure function of ``(state, r)``.  With ``base =
key(seed)`` (the port's JAX-compatible threefry, ``core.prng``), round r
draws the edge mask under ``fold_in(fold_in(base, r), 0)``
(``core.dynamic.edge_mask``) and the ``random`` kind's scores under
``fold_in(fold_in(base, r·resample), 1)``, as the reference does.

``reactive=True`` recomputes the centrality on the round's surviving
graph with the tensor kernels below — degree, eigenvector (200 steps of
the ``A + I`` power method), PageRank (200 steps, dangling mass spread
uniformly) and closeness (matrix-power hop counts) — and, with
``sparse=True``, the eigenvector and PageRank steps run on padded-ELL
tables (:func:`sparse_matvec`).  Betweenness has no fixed-shape kernel:
a reactive program refuses it unless ``allow_nominal_betweenness`` opts
into the nominal scores (:meth:`CoeffProgram.validate_state_kinds`).

The program runs on the host in f32 torch ops: its matrices are tiny and
the trainer copies each round's to the card.  :class:`ProgramCoeffs` is
one program with the states of a sweep's E experiments: the sweep engine
makes each round's ``(E, n, n)`` matrices from it inside its round loop,
in place of an ``(E, R, n, n)`` stack.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core import prng
from repro_torch.core.dynamic import edge_mask
from repro_torch.core.strategies import (
    AggregationStrategy,
    masked_normalize,
    masked_softmax,
    renormalize_rows,
    strategy_scores,
)
from repro_torch.core.topology import Topology

__all__ = ["PROGRAM_KINDS", "PORTED_KINDS", "CENTRALITY_KINDS",
           "CoeffProgram", "ProgramCoeffs", "program_for",
           "participation_renormalize",
           "quarantine_renormalize", "stack_states", "state_nbytes",
           "degree_centrality", "eigenvector_centrality",
           "pagerank_centrality", "closeness_centrality", "sparse_matvec",
           "eigenvector_centrality_sparse", "pagerank_centrality_sparse"]

# the reference's lax.switch branch order — state["kind"] indexes it
PROGRAM_KINDS = ("unweighted", "weighted", "random", "fl", "degree",
                 "betweenness", "eigenvector", "pagerank", "closeness")
PORTED_KINDS = PROGRAM_KINDS
# kinds whose state carries nominal (host-computed) centrality scores
CENTRALITY_KINDS = ("degree", "betweenness", "eigenvector", "pagerank",
                    "closeness")


# ----------------------------------------------------------------------
# centrality kernels (fixed iteration counts, as the reference's)
# ----------------------------------------------------------------------
def degree_centrality(adj: torch.Tensor) -> torch.Tensor:
    """degree / (n − 1), networkx's normalization."""
    return adj.sum(-1) / max(adj.shape[-1] - 1, 1)


def _power_steps(matvec, n: int, dtype, iters: int) -> torch.Tensor:
    """``iters`` steps of x ← (A + I)x / ‖(A + I)x‖ from the uniform unit
    vector; a zero step (no edge left) keeps x instead of dividing by 0."""
    x = torch.full((n,), 1.0 / np.sqrt(n), dtype=dtype)
    for _ in range(iters):
        y = matvec(x) + x
        norm = torch.sqrt((y * y).sum())
        x = torch.where(norm > 1e-12, y / torch.clamp(norm, min=1e-12), x)
    return x


def eigenvector_centrality(adj: torch.Tensor,
                           iters: int = 200) -> torch.Tensor:
    """Principal adjacency eigenvector by the ``A + I`` power method (the
    shift keeps the top eigenvalue dominant on bipartite survivors)."""
    return _power_steps(lambda x: adj @ x, adj.shape[-1], adj.dtype, iters)


def _pagerank_steps(step, n: int, dangling: torch.Tensor, dtype,
                    alpha: float, iters: int) -> torch.Tensor:
    x = torch.full((n,), 1.0 / n, dtype=dtype)
    zero = torch.zeros((), dtype=dtype)
    for _ in range(iters):
        dmass = torch.where(dangling, x, zero).sum()
        x = alpha * (step(x) + dmass / n) + (1.0 - alpha) / n
    return x


def pagerank_centrality(adj: torch.Tensor, alpha: float = 0.85,
                        iters: int = 200) -> torch.Tensor:
    """PageRank mass by ``iters`` power steps, networkx's semantics:
    uniform teleport, dangling (isolated) nodes' mass spread uniformly."""
    deg = adj.sum(-1)
    dangling = deg <= 0
    p = adj / torch.where(dangling, torch.ones_like(deg), deg)[:, None]
    return _pagerank_steps(lambda x: x @ p, adj.shape[-1], dangling,
                           adj.dtype, alpha, iters)


def closeness_centrality(adj: torch.Tensor) -> torch.Tensor:
    """Closeness from hop counts: ``(I + A)^k > 0`` is reachability in k
    hops, a pair's distance the first k that reaches it; Wasserman–Faust
    scaling ``((r−1)/Σd)·(r−1)/(n−1)``, isolated nodes 0."""
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=adj.dtype)
    hop = torch.clamp(adj + eye, max=1.0)
    reach, dist = eye, torch.zeros((n, n), dtype=adj.dtype)
    for k in range(1, max(n, 2)):
        new_reach = torch.clamp(reach @ hop, max=1.0)
        newly = (new_reach > 0) & (reach == 0)
        dist = dist + torch.where(newly, torch.tensor(float(k), dtype=adj.dtype),
                                  torch.zeros((), dtype=adj.dtype))
        reach = new_reach
    r = reach.sum(1)
    sd = dist.sum(1)
    return torch.where(sd > 0,
                       (r - 1.0) / torch.clamp(sd, min=1.0) * (r - 1.0)
                       / max(n - 1, 1),
                       torch.zeros((), dtype=adj.dtype))


def sparse_matvec(nbr_idx: torch.Tensor, nbr_val: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """``(A @ x)[i] = Σ_d nbr_val[i, d] · x[nbr_idx[i, d]]`` over padded-ELL
    tables (padding slots carry value 0)."""
    return (nbr_val * x[nbr_idx]).sum(-1)


def eigenvector_centrality_sparse(nbr_idx: torch.Tensor,
                                  nbr_val: torch.Tensor,
                                  iters: int = 200) -> torch.Tensor:
    """:func:`eigenvector_centrality` with each step a
    :func:`sparse_matvec`."""
    return _power_steps(lambda x: sparse_matvec(nbr_idx, nbr_val, x),
                        nbr_idx.shape[0], nbr_val.dtype, iters)


def pagerank_centrality_sparse(nbr_idx: torch.Tensor, nbr_val: torch.Tensor,
                               alpha: float = 0.85,
                               iters: int = 200) -> torch.Tensor:
    """:func:`pagerank_centrality` on padded-ELL tables: for a symmetric
    adjacency, ``(x @ P)[j]`` is a gather over j's own neighbours of
    ``x / deg``."""
    deg = nbr_val.sum(-1)
    dangling = deg <= 0
    inv_deg = torch.where(
        dangling, torch.zeros_like(deg),
        1.0 / torch.where(dangling, torch.ones_like(deg), deg))
    return _pagerank_steps(
        lambda x: sparse_matvec(nbr_idx, nbr_val, x * inv_deg),
        nbr_idx.shape[0], dangling, nbr_val.dtype, alpha, iters)


# ----------------------------------------------------------------------
# the program
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CoeffProgram:
    """Per-round f32 mixing-matrix generator for one experiment.

    ``reactive``: centralities recomputed on each round's survivor
    (nominal scores restricted to the surviving support otherwise).
    ``sparse``: the reactive eigenvector and PageRank steps on the state's
    ``nbr_idx``/``nbr_val`` tables (closeness stays dense).  ``kinds``:
    the sorted ``PROGRAM_KINDS`` indices the program serves (None: all);
    a state of another kind is refused.  ``link_failure=False`` skips the
    edge mask (the same matrices as ``p_fail = 0``)."""

    n_nodes: int
    reactive: bool = False
    power_iters: int = 200
    pagerank_iters: int = 200
    pagerank_alpha: float = 0.85
    sparse: bool = False
    kinds: Optional[tuple] = None
    link_failure: bool = True
    allow_nominal_betweenness: bool = False

    def __post_init__(self):
        if self.kinds is None:
            return
        kinds = tuple(sorted({int(k) for k in self.kinds}))
        if not kinds or kinds[0] < 0 or kinds[-1] >= len(PROGRAM_KINDS):
            raise ValueError(
                f"CoeffProgram.kinds must be non-empty indices into "
                f"PROGRAM_KINDS (0..{len(PROGRAM_KINDS) - 1}); got "
                f"{self.kinds!r}")
        object.__setattr__(self, "kinds", kinds)

    def validate_state_kinds(self, state) -> None:
        """Refuse a state (optionally with a leading experiment axis)
        whose kind the pruned program does not serve, and reactive
        betweenness unless ``allow_nominal_betweenness`` is set."""
        present = {int(k) for k in np.asarray(state["kind"]).ravel()}
        if (self.reactive and PROGRAM_KINDS.index("betweenness") in present
                and not self.allow_nominal_betweenness):
            raise ValueError(
                "reactive CoeffProgram got a 'betweenness' state: "
                "betweenness has no fixed-shape kernel, so the program "
                "would serve NOMINAL scores while every other kind "
                "recomputes on the surviving subgraph; use reactive=False, "
                "a reactive centrality (degree/eigenvector/pagerank/"
                "closeness), or allow_nominal_betweenness=True")
        if self.kinds is None:
            return
        bad = sorted(present - set(self.kinds))
        if bad:
            raise ValueError(
                f"CoeffProgram pruned to kinds {self.kinds} "
                f"({[PROGRAM_KINDS[k] for k in self.kinds]}) got state "
                f"kind(s) {bad} ({[PROGRAM_KINDS[k] for k in bad]}); "
                f"rebuild the program with the union of the grid's kinds")

    def matrix(self, state, round_idx: int) -> torch.Tensor:
        """(n, n) f32 row-stochastic matrix for round ``round_idx`` (the
        absolute round)."""
        n = self.n_nodes
        r = int(round_idx)
        adj = torch.as_tensor(np.asarray(state["adj"]))
        base = prng.key(int(state["seed"]))
        if self.link_failure:
            em = torch.as_tensor(edge_mask(prng.fold_in(prng.fold_in(base, r), 0),
                                           n, state["p_fail"]))
            adj_r = adj * em
        else:
            adj_r = adj
        mask = adj_r + torch.eye(n, dtype=adj.dtype)
        tau = torch.as_tensor(state["tau"])
        kind = PROGRAM_KINDS[int(state["kind"])]

        def soft(scores):
            return masked_softmax(scores, mask, tau)

        def centrality(kernel, sparse_kernel=None):
            if not self.reactive:
                return torch.as_tensor(np.asarray(state["scores"]))
            if self.sparse and sparse_kernel is not None:
                nbr_idx = torch.as_tensor(np.asarray(state["nbr_idx"]),
                                          dtype=torch.long)
                nbr_val = torch.as_tensor(np.asarray(state["nbr_val"]))
                if self.link_failure:
                    nbr_val = nbr_val * em[torch.arange(n)[:, None], nbr_idx]
                return sparse_kernel(nbr_idx, nbr_val)
            return kernel(adj_r)

        if kind == "unweighted":
            return masked_normalize(torch.ones(n, dtype=adj.dtype), mask)
        if kind == "weighted":
            return masked_normalize(torch.as_tensor(state["counts"]), mask)
        if kind == "random":
            k = prng.fold_in(prng.fold_in(base, r * int(state["resample"])),
                             1)
            return soft(torch.as_tensor(prng.uniform(k, n)))
        if kind == "fl":
            # the idealized fully-connected baseline: churn does not touch it
            return torch.full((n, n), 1.0 / n, dtype=adj.dtype)
        if kind == "degree":
            return soft(centrality(
                degree_centrality,
                lambda i, v: v.sum(-1) / max(n - 1, 1)))
        if kind == "betweenness":
            return soft(torch.as_tensor(np.asarray(state["scores"])))
        if kind == "eigenvector":
            return soft(centrality(
                lambda a: eigenvector_centrality(a, self.power_iters),
                lambda i, v: eigenvector_centrality_sparse(
                    i, v, self.power_iters)))
        if kind == "pagerank":
            def scaled(pr):
                return pr / pr.max()
            return soft(centrality(
                lambda a: scaled(pagerank_centrality(
                    a, self.pagerank_alpha, self.pagerank_iters)),
                lambda i, v: scaled(pagerank_centrality_sparse(
                    i, v, self.pagerank_alpha, self.pagerank_iters))))
        return soft(centrality(closeness_centrality))   # dense when sparse

    def materialize(self, state, rounds: Optional[int] = None,
                    round_indices=None) -> np.ndarray:
        """(R, n, n) float32 stack of the program's per-round matrices."""
        if round_indices is None:
            if rounds is None:
                raise ValueError("materialize needs rounds or round_indices")
            round_indices = np.arange(int(rounds))
        self.validate_state_kinds(state)
        return np.stack([self.matrix(state, int(r)).numpy()
                         for r in np.asarray(round_indices)])


def program_for(topo: Topology, strategy: AggregationStrategy,
                data_counts: Optional[np.ndarray] = None,
                p_fail: float = 0.0, reactive: bool = False,
                resample_random: bool = True, **program_kwargs):
    """``(program, state)`` for one topology × strategy cell.  ``state``
    holds the reference's leaves: f32 adjacency, nominal scores and
    counts, τ, the kind index, the uint32 seed, ``p_fail``, ``resample``,
    and with ``sparse=True`` the neighbour tables ``nbr_idx``/``nbr_val``
    (self excluded).  ``p_fail`` leaves ``fl`` unchanged."""
    if strategy.kind not in PROGRAM_KINDS:
        raise KeyError(
            f"strategy {strategy.kind!r} has no coefficient program; "
            f"supported: {sorted(PROGRAM_KINDS)} "
            f"(others keep the host-side mixing_matrix path)")
    n = topo.n_nodes
    if strategy.kind == "weighted" and data_counts is None:
        raise ValueError("'weighted' strategy needs per-node data_counts")
    counts = (np.ones(n) if data_counts is None
              else np.asarray(data_counts, dtype=np.float64))
    if counts.shape != (n,):
        raise ValueError(f"data_counts shape {counts.shape} != ({n},)")
    scores = np.zeros(n)
    if strategy.kind in CENTRALITY_KINDS:
        scores = strategy_scores(topo, strategy)
    state = {
        "adj": np.asarray(topo.adjacency, np.float32),
        "scores": np.asarray(scores, np.float32),
        "counts": np.asarray(counts, np.float32),
        "tau": np.float32(strategy.tau),
        "kind": np.int32(PROGRAM_KINDS.index(strategy.kind)),
        "seed": np.uint32(strategy.seed),
        "p_fail": np.float32(p_fail),
        "resample": np.int32(bool(resample_random)),
    }
    program = CoeffProgram(n_nodes=n, reactive=bool(reactive),
                           **program_kwargs)
    if program.sparse:
        nbr_idx, nbr_mask = topo.neighbor_tables(include_self=False)
        state["nbr_idx"] = np.asarray(nbr_idx, np.int32)
        state["nbr_val"] = np.asarray(nbr_mask, np.float32)
    return program, state


@dataclasses.dataclass
class ProgramCoeffs:
    """In place of the ``(E, R, n, n)`` stack in ``SweepEngine.run``: one
    shared program and the experiments' states stacked on a leading E
    axis (:func:`stack_states`)."""

    program: CoeffProgram
    states: dict

    @property
    def n_experiments(self) -> int:
        return int(np.asarray(tree_util.leaves(self.states)[0]).shape[0])

    def state(self, e: int) -> dict:
        """Experiment e's state."""
        return {k: np.asarray(v)[e] for k, v in self.states.items()}

    def matrices(self, round_idx: int) -> np.ndarray:
        """``(E, n, n)`` float32: every experiment's matrix for the
        absolute round ``round_idx``."""
        return np.stack([self.program.matrix(self.state(e), round_idx)
                         .numpy() for e in range(self.n_experiments)])


def stack_states(states: Sequence[dict]) -> dict:
    """[state] * E → one state with a leading E axis."""
    return {k: np.stack([np.asarray(s[k]) for s in states])
            for k in states[0]}


def state_nbytes(state) -> int:
    """Host bytes of a state."""
    return int(sum(np.asarray(x).nbytes for x in tree_util.leaves(state)))


def participation_renormalize(c: torch.Tensor,
                              active: torch.Tensor) -> torch.Tensor:
    """Drop inactive *columns* from a row-stochastic mixing matrix and
    renormalize the surviving rows (``stale_mixing=False`` partial
    participation; ``c`` may carry a leading experiment axis, ``(E, n,
    n)`` against ``(E, n)`` masks).  Rows that lost no mass come back
    BIT-identical (the
    row-level ``changed`` gate skips the divide), so an all-active round
    reproduces the matrix exactly; rows whose whole support went inactive
    fall back to self-weight 1."""
    masked = c * active.to(c.dtype)[..., None, :]
    changed = (masked != c).any(dim=-1, keepdim=True)
    return torch.where(changed, renormalize_rows(masked), c)


def quarantine_renormalize(c: torch.Tensor,
                           quarantined: torch.Tensor) -> torch.Tensor:
    """Excise quarantined nodes' columns and renormalize the surviving
    rows: :func:`participation_renormalize` with ``active =
    ~quarantined``, ``changed`` gate included, so a round with nothing
    quarantined returns the matrix bit-identical."""
    return participation_renormalize(c, torch.logical_not(quarantined))
