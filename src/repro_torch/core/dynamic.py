"""Per-round dynamics: link failure, partial participation and Byzantine
faults (port of ``repro/core/dynamic.py``).

Link failure drops each undirected edge i.i.d. with probability
``p_fail`` a round, in two forms as in the reference: the host schedules
(:func:`drop_edges`, :func:`dynamic_mixing_matrix`,
:func:`link_failure_schedule`, numpy's ``default_rng`` per round, float64)
and the coefficient program's :func:`edge_mask` (the threefry ``(n, n)``
uniform draw at fold index 0, mirrored from its upper triangle).

Each spec is the static half of its layer; the per-run rate and seed ride
in the carries of ``core.decentralized`` (``participation_carry_init``,
``fault_carry_init``).  The per-round masks come from the port's
JAX-compatible threefry (``core.prng``) with the reference's key
convention ``fold_in(fold_in(key(seed), round), i)``: fold index 2 for
participation, 3 for faults (0 and 1 belong to the edge mask and the
Random strategy).  They are drawn on the host as ``(n,)`` numpy bools and
equal the reference's masks bit for bit.  Uniform draws lie in [0, 1), so
rate 1.0 activates every node and fault rate 0.0 marks none, exactly.
A rate and a seed may also be ``(E,)`` arrays, one per experiment of the
sweep engine: the masks then come back ``(E, n)``.

The ``"noise"`` fault draws ``jax.random.normal``'s stream
(``prng.normal_at``) for the faulty rows only: a value depends on its key
and flat index alone, so a row's counters give the same values as the
whole-leaf draw at a fraction of the host threefry's cost.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import to_device
from repro_torch import tree as tree_util
from repro_torch.core import prng
from repro_torch.core.strategies import (
    AggregationStrategy,
    mixing_matrix,
    renormalize_rows,
)
from repro_torch.core.topology import Topology

__all__ = ["edge_mask", "drop_edges", "dynamic_mixing_matrix",
           "link_failure_schedule", "PARTICIPATION_MODES",
           "ParticipationSpec", "FAULT_MODES", "FaultSpec"]

PARTICIPATION_MODES = ("bernoulli", "duty")
FAULT_MODES = ("nan", "inf", "noise", "signflip", "zero")


def _round_key(seed, round_idx, fold: int) -> np.ndarray:
    return prng.fold_in(prng.fold_in(prng.key(seed), round_idx), fold)


def _draw_per_experiment(draw, rate, seed, round_idx, n: int) -> np.ndarray:
    """``draw(rate, seed, round_idx, n)`` for scalars, or stacked over the
    experiments when ``rate``/``seed`` are ``(E,)`` arrays."""
    if np.ndim(rate) == 0 and np.ndim(seed) == 0:
        return draw(rate, seed, round_idx, n)
    rate, seed = np.broadcast_arrays(np.asarray(rate), np.asarray(seed))
    return np.stack([draw(r, s, round_idx, n) for r, s in zip(rate, seed)])


@dataclasses.dataclass(frozen=True)
class ParticipationSpec:
    """Which nodes train and gossip in a round.

    ``mode="bernoulli"``: each node active i.i.d. with probability
    ``rate`` (fold index 2).  ``mode="duty"``: node i is active in round r
    iff ``(r + i) % period < floor(rate·period + 0.5)`` (f32 arithmetic,
    as the reference).  ``stale_mixing=True``: inactive nodes' published
    rows stay as last published; False: their columns are dropped from
    the mix and rows renormalised.
    """

    mode: str = "bernoulli"
    stale_mixing: bool = True
    period: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.mode not in PARTICIPATION_MODES:
            raise ValueError(f"participation mode {self.mode!r} not in "
                             f"{PARTICIPATION_MODES}")
        if self.mode == "duty" and self.period < 1:
            raise ValueError("duty-cycle participation needs period >= 1")

    def active_mask(self, rate, pseed, round_idx, n: int) -> np.ndarray:
        """``(n,)`` bool active mask for one round (``(E, n)`` for ``(E,)``
        rates and seeds)."""
        return _draw_per_experiment(self._active_mask, rate, pseed,
                                    round_idx, n)

    def _active_mask(self, rate, pseed, round_idx, n: int) -> np.ndarray:
        if self.mode == "bernoulli":
            u = prng.uniform(_round_key(pseed, round_idx, 2), n)
            return u < np.float32(rate)
        k = np.int32(np.floor(np.float32(rate) * np.float32(self.period)
                              + np.float32(0.5)))
        phase = (int(round_idx) + np.arange(n, dtype=np.int32)) % self.period
        return phase < k


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Byzantine / corruption faults on the PUBLISHED parameter plane.

    Each round each node is faulty i.i.d. with probability ``rate`` (fold
    index 3); a faulty node's neighbours see ``corrupt``'s garbage in its
    place while the node keeps its own trained params.  Modes: ``"nan"``
    / ``"inf"`` (the row poisoned wholesale), ``"noise"`` (the row plus
    ``noise_scale`` times a standard normal draw, leaf i's under
    ``fold_in(round key, i)``), ``"signflip"`` (the row times
    ``-byz_scale``), ``"zero"``.  ``seed`` is the first experiment's
    fault seed in the sweep engine (experiment e draws under ``seed +
    e`` unless given its own).  ``quarantine=True`` turns on the screen of
    ``core.decentralized.make_fault_round_fn``: a row with a nonfinite
    value or a norm above ``spike_ratio`` × its EMA (``ema_beta``) is
    quarantined for ``probation`` rounds.
    """

    mode: str = "signflip"
    noise_scale: float = 1.0
    byz_scale: float = 3.0
    seed: int = 0
    quarantine: bool = False
    probation: int = 3
    spike_ratio: float = 10.0
    ema_beta: float = 0.9

    def __post_init__(self):
        if self.mode not in FAULT_MODES:
            raise ValueError(f"fault mode {self.mode!r} not in "
                             f"{FAULT_MODES}")
        if self.quarantine and self.probation < 1:
            raise ValueError("quarantine needs probation >= 1")

    def faulty_mask(self, rate, fseed, round_idx, n: int) -> np.ndarray:
        """``(n,)`` bool faulty mask for one round (``(E, n)`` for
        ``(E,)`` rates and seeds)."""
        return _draw_per_experiment(
            lambda r, s, ri, m: prng.uniform(_round_key(s, ri, 3), m)
            < np.float32(r), rate, fseed, round_idx, n)

    def corrupt(self, stacked_params, fseed=None, round_idx=None,
                faulty=None):
        """Corrupted copy of a stacked tree (leaves ``(n, ...)``, or ``(E,
        n, ...)`` with ``(E,)`` seeds); the caller selects the faulty rows
        out of it.  ``"noise"`` needs the round's ``fseed`` and
        ``round_idx`` and draws only the rows that the host mask
        ``faulty`` (the leaves' leading shape; None: every row) marks —
        the other rows come back unchanged."""
        if self.mode == "noise":
            return self._noisy(stacked_params, fseed, round_idx, faulty)

        def bad(leaf):
            if self.mode == "nan":
                return torch.full_like(leaf, float("nan"))
            if self.mode == "inf":
                return torch.full_like(leaf, float("inf"))
            if self.mode == "zero":
                return torch.zeros_like(leaf)
            # the scale rounded to the leaf dtype first, as the reference
            return torch.tensor(-self.byz_scale, dtype=leaf.dtype) * leaf

        return tree_util.tree_map(bad, stacked_params)

    def _noisy(self, stacked_params, fseed, round_idx, faulty):
        if fseed is None or round_idx is None:
            raise ValueError("fault mode 'noise' needs the round's fseed "
                             "and round_idx")
        leaves, treedef = tree_util.flatten(stacked_params)
        lead = 1 if np.ndim(fseed) == 0 else 2
        rows_shape = tuple(leaves[0].shape[:lead])
        faulty = (np.ones(rows_shape, bool) if faulty is None
                  else np.asarray(faulty, bool))
        if faulty.shape != rows_shape:
            raise ValueError(f"faulty mask {faulty.shape} != the leaves' "
                             f"leading shape {rows_shape}")
        seeds = np.broadcast_to(np.asarray(fseed), rows_shape[:-1])
        pos = np.argwhere(faulty)                  # (k, lead), row-major
        groups = [(pos[:, 0] == e) for e in range(rows_shape[0])] \
            if lead == 2 else [np.ones(len(pos), bool)]
        keys = [_round_key(int(s), round_idx, 3) for s in seeds.ravel()] \
            if lead == 2 else [_round_key(int(fseed), round_idx, 3)]
        out = []
        for i, leaf in enumerate(leaves):
            if leaf.dtype != torch.float32:
                raise NotImplementedError(
                    f"fault mode 'noise' draws float32 values; a "
                    f"{leaf.dtype} leaf needs jax's draw in that dtype")
            if not len(pos):
                out.append(leaf)
                continue
            size = math.prod(leaf.shape[lead:])
            noise = np.empty((len(pos), size), np.float32)
            for key, sel in zip(keys, groups):
                if sel.any():
                    rows = pos[sel, -1].astype(np.int64)
                    noise[sel] = prng.normal_at(
                        prng.fold_in(key, i),
                        rows[:, None] * size + np.arange(size)[None])
            idx = tuple(to_device(pos[:, d], leaf.device)
                        for d in range(lead))
            noise_t = to_device(noise, leaf.device).reshape(
                (len(pos),) + tuple(leaf.shape[lead:]))
            scale = torch.tensor(self.noise_scale, dtype=leaf.dtype)
            bad = leaf.clone()
            bad[idx] = leaf[idx] + scale * noise_t
            out.append(bad)
        return tree_util.unflatten(treedef, out)


# ----------------------------------------------------------------------
# link failure
# ----------------------------------------------------------------------
def edge_mask(k: np.ndarray, n: int, p_fail) -> np.ndarray:
    """(n, n) f32 symmetric 0/1 keep-mask under the threefry key ``k``: one
    uniform draw per upper-triangle entry, mirrored, kept where ``u >=
    p_fail`` (f32), the diagonal always kept.  ``p_fail = 0`` keeps every
    edge exactly (draws lie in [0, 1))."""
    u = np.triu(prng.uniform(k, (n, n)), k=1)
    u = u + u.T
    keep = (u >= np.float32(p_fail)) | np.eye(n, dtype=bool)
    return keep.astype(np.float32)


def drop_edges(topo: Topology, p_fail: float,
               rng: np.random.Generator) -> Topology:
    """Remove each undirected edge with probability ``p_fail`` (one
    ``rng.random`` draw per upper-triangle pair).  The survivor may be
    disconnected; every node keeps its self-loop in the mixing support."""
    a = topo.adjacency.copy()
    n = topo.n_nodes
    iu = np.triu_indices(n, k=1)
    mask = (a[iu] > 0) & (rng.random(len(iu[0])) < p_fail)
    a[iu[0][mask], iu[1][mask]] = 0.0
    a[iu[1][mask], iu[0][mask]] = 0.0
    return Topology(a, name=f"{topo.name}_drop{p_fail}", seed=topo.seed)


def dynamic_mixing_matrix(topo: Topology, strategy: AggregationStrategy,
                          round_idx: int, p_fail: float,
                          data_counts: Optional[np.ndarray] = None,
                          reactive: bool = False) -> np.ndarray:
    """Float64 mixing matrix for one round under link failure, the
    survivor drawn from ``default_rng((seed·1_000_003 + r)·7919 + 17)``.

    ``reactive=False``: nominal scores, the nominal matrix restricted to
    the surviving support and renormalized (rows left with nothing fall
    back to self-weight 1).  ``reactive=True`` (and the kinds without a
    centrality): the strategy rebuilt on the survivor, so ``eigenvector``
    raises ``topology.AmbiguousSolution`` on a disconnected survivor, as
    the reference's networkx does."""
    rng = np.random.default_rng(
        (strategy.seed * 1_000_003 + round_idx) * 7919 + 17)
    surv = drop_edges(topo, p_fail, rng)
    if reactive or strategy.kind in ("unweighted", "weighted", "random",
                                     "fl"):
        return mixing_matrix(surv, strategy, data_counts=data_counts)
    full = mixing_matrix(topo, strategy, data_counts=data_counts)
    return renormalize_rows(full * (surv.adjacency + np.eye(topo.n_nodes)))


def link_failure_schedule(topo: Topology, strategy: AggregationStrategy,
                          rounds: int, p_fail: float,
                          data_counts: Optional[np.ndarray] = None,
                          reactive: bool = False) -> np.ndarray:
    """(R, n, n) stack of :func:`dynamic_mixing_matrix` for rounds 0..R−1."""
    return np.stack([
        dynamic_mixing_matrix(topo, strategy, r, p_fail,
                              data_counts=data_counts, reactive=reactive)
        for r in range(rounds)])
