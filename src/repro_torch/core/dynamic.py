"""Per-round node dynamics: partial participation and Byzantine faults
(port of ``ParticipationSpec`` and ``FaultSpec`` in
``repro/core/dynamic.py``).

Each spec is the static half of its layer; the per-run rate and seed ride
in the carries of ``core.decentralized`` (``participation_carry_init``,
``fault_carry_init``).  The per-round masks come from the port's
JAX-compatible threefry (``core.prng``) with the reference's key
convention ``fold_in(fold_in(key(seed), round), i)``: fold index 2 for
participation, 3 for faults (0 and 1 belong to the edge mask and the
Random strategy).  They are drawn on the host as ``(n,)`` numpy bools and
equal the reference's masks bit for bit.  Uniform draws lie in [0, 1), so
rate 1.0 activates every node and fault rate 0.0 marks none, exactly.

Link failure (``edge_mask``, ``drop_edges``, ``link_failure_schedule``)
and the ``"noise"`` fault mode, which needs ``jax.random.normal``'s
stream, wait for ROADMAP Queue 1 [links].
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core import prng

__all__ = ["PARTICIPATION_MODES", "ParticipationSpec", "FAULT_MODES",
           "FaultSpec"]

PARTICIPATION_MODES = ("bernoulli", "duty")
FAULT_MODES = ("nan", "inf", "noise", "signflip", "zero")


def _round_key(seed, round_idx, fold: int) -> np.ndarray:
    return prng.fold_in(prng.fold_in(prng.key(seed), round_idx), fold)


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

    def __post_init__(self):
        if self.mode not in PARTICIPATION_MODES:
            raise ValueError(f"participation mode {self.mode!r} not in "
                             f"{PARTICIPATION_MODES}")
        if self.mode == "duty" and self.period < 1:
            raise ValueError("duty-cycle participation needs period >= 1")

    def active_mask(self, rate, pseed, round_idx, n: int) -> np.ndarray:
        """``(n,)`` bool active mask for one round."""
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
    / ``"inf"`` (the row poisoned wholesale), ``"signflip"`` (the row
    times ``-byz_scale``), ``"zero"``.  ``"noise"`` is not ported yet.
    ``quarantine=True`` turns on the screen of
    ``core.decentralized.make_fault_round_fn``: a row with a nonfinite
    value or a norm above ``spike_ratio`` × its EMA (``ema_beta``) is
    quarantined for ``probation`` rounds.
    """

    mode: str = "signflip"
    byz_scale: float = 3.0
    quarantine: bool = False
    probation: int = 3
    spike_ratio: float = 10.0
    ema_beta: float = 0.9

    def __post_init__(self):
        if self.mode not in FAULT_MODES:
            raise ValueError(f"fault mode {self.mode!r} not in "
                             f"{FAULT_MODES}")
        if self.mode == "noise":
            raise NotImplementedError(
                "fault mode 'noise' needs jax.random.normal's stream, which "
                "the port's threefry does not draw yet (ROADMAP Queue 1 "
                "[links])")
        if self.quarantine and self.probation < 1:
            raise ValueError("quarantine needs probation >= 1")

    def faulty_mask(self, rate, fseed, round_idx, n: int) -> np.ndarray:
        """``(n,)`` bool faulty mask for one round."""
        return prng.uniform(_round_key(fseed, round_idx, 3), n) < \
            np.float32(rate)

    def corrupt(self, stacked_params):
        """Fully corrupted copy of a stacked ``(n, ...)`` tree; the caller
        selects the faulty rows out of it."""
        def bad(leaf):
            if self.mode == "nan":
                return torch.full_like(leaf, float("nan"))
            if self.mode == "inf":
                return torch.full_like(leaf, float("inf"))
            if self.mode == "zero":
                return torch.zeros_like(leaf)
            return torch.tensor(-self.byz_scale, dtype=leaf.dtype,
                                device=leaf.device) * leaf

        return tree_util.tree_map(bad, stacked_params)
