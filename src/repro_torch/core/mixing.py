"""Apply a mixing matrix to a stacked model tree (port of
``repro/core/mixing.py``).

Eq. (2), ``m_i ← Σ_j C[i, j] · m_j``, over trees whose leaves carry a
leading node axis ``(n, ...)``:

* :func:`mix_dense` — every leaf contracted against the dense (n, n)
  matrix (``mix_impl="einsum"``; a plain matrix product per leaf, left to
  the library as the reference leaves it to XLA);
* :func:`mix_edges` — the padded-ELL gather-accumulate over static
  neighbour tables with per-edge weights gathered from the live matrix
  (:func:`edge_weights`);
* :func:`mix_sparse` — the circulant schedule (``mix_impl="sparse"``): the
  matrix as a sum of weighted ring shifts ``w_k[i] · leaf[(i + k) % n]``
  over a static offset set (:func:`sparse_offsets`, from the topology's
  support) with the weights gathered from the live matrix.  On one card a
  ring shift is a ``torch.roll``; on the reference's TPU mesh it is one
  collective permute, so :func:`mixing_collective_bytes` models the bytes
  it moves there.  :func:`circulant_decomposition` and
  :func:`mix_sparse_host` are the schedule as host data and its
  single-host reference.

They accumulate in f32 by default; ``mix_in_float32=False`` accumulates
in the leaf dtype (the low-precision-aggregation ablation).

The sweep engine's form: :func:`mix_dense`, :func:`mix_robust_tables`,
:func:`plane_norms` and :func:`norm_clip_coeffs` also take a leading
experiment axis — trees with leaves ``(E, n, ...)`` against ``(E, n, n)``
matrices — and give each experiment exactly what its own call would
(:func:`per_experiment`).

Robust aggregation (DESIGN.md §16): :func:`robust_combine` replaces the
weighted mean by a coordinate-wise trimmed mean or median over each
destination's occupied table slots, :func:`mix_robust_tables` applies it
leaf by leaf, and :func:`norm_clip_coeffs` is the ``norm_clip`` rule as an
``(n, n)`` coefficient transform in front of any mix.  Unlike the
reference, the trimmed mean's two sums run in ascending sorted slot order
(an explicit loop, not ``tensor.sum``), so the CUDA kernel
``kernels.gossip_mix.gossip_robust`` can equal this plain version bit for
bit; against the reference's XLA reduction it differs in the last ulps.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core.strategies import renormalize_rows

__all__ = [
    "per_experiment",
    "mix_dense",
    "edge_weights",
    "mix_edges",
    "CirculantSchedule",
    "circulant_decomposition",
    "sparse_offsets",
    "mix_sparse",
    "mix_sparse_host",
    "mixing_collective_bytes",
    "ROBUST_MODES",
    "oddeven_sort_pairs",
    "robust_combine",
    "mix_robust_tables",
    "plane_norms",
    "norm_clip_coeffs",
]

#: robust rules accepted by ``core.decentralized.make_mix_fn(robust=...)``
ROBUST_MODES = ("mean", "trimmed", "median", "norm_clip")

# nonfinite values are clamped to ±_ROBUST_BIG before the sort (a poisoned
# coordinate is an extreme outlier, not a NaN comparison); unoccupied
# slots get _ROBUST_PAD, beyond the clamp, so they sort after every value
_ROBUST_BIG = 1e30
_ROBUST_PAD = 2e30


def _leaf_mix(c: torch.Tensor, leaf: torch.Tensor,
              mix_in_float32: bool = True) -> torch.Tensor:
    acc_dtype = torch.float32 if mix_in_float32 else leaf.dtype
    n = leaf.shape[0]
    acc = c.to(acc_dtype) @ leaf.reshape(n, -1).to(acc_dtype)
    return acc.reshape(leaf.shape).to(leaf.dtype)


def per_experiment(mix, params, coeffs: torch.Tensor, *args, **kwargs):
    """``mix(params, coeffs, ...)`` for each experiment of a batched tree
    (leaves ``(E, n, ...)``, ``coeffs`` ``(E, n, n)``), stacked: bit for
    bit E separate calls."""
    outs = [mix(tree_util.tree_map(lambda x: x[e], params), coeffs[e],
                *args, **kwargs) for e in range(coeffs.shape[0])]
    return tree_util.tree_map(lambda *xs: torch.stack(xs), *outs)


def mix_dense(params, coeffs: torch.Tensor, mix_in_float32: bool = True):
    """Dense gossip: every leaf ``(n, ...)`` contracted against the
    ``(n, n)`` matrix (or each experiment's, for ``(E, n, n)``)."""
    if coeffs.ndim == 3:
        return per_experiment(mix_dense, params, coeffs, mix_in_float32)
    return tree_util.tree_map(
        lambda leaf: _leaf_mix(coeffs, leaf, mix_in_float32), params)


# ----------------------------------------------------------------------
# circulant (ring-offset) schedule
# ----------------------------------------------------------------------
class CirculantSchedule:
    """An (n, n) matrix as ring offsets: for each offset ``k`` with any
    nonzero ``C[i, (i + k) % n]``, the per-destination weights
    ``w_k[i] = C[i, (i + k) % n]``, so that
    ``(C @ M)[i] = Σ_k w_k[i] · M[(i + k) % n]``."""

    def __init__(self, offsets: Sequence[int], weights: np.ndarray, n: int):
        self.offsets: Tuple[int, ...] = tuple(int(o) for o in offsets)
        self.weights = np.asarray(weights, dtype=np.float32)  # (K, n)
        self.n = n
        if self.weights.shape != (len(self.offsets), n):
            raise ValueError(f"weights {self.weights.shape} != "
                             f"({len(self.offsets)}, {n})")

    def __len__(self) -> int:
        return len(self.offsets)

    def __repr__(self) -> str:
        return f"CirculantSchedule(n={self.n}, offsets={self.offsets})"


def circulant_decomposition(coeffs: np.ndarray) -> CirculantSchedule:
    """Exact decomposition of an (n, n) matrix (cast to f32) into its
    nonzero ring offsets, offset 0 (the self-weight) included."""
    c = np.asarray(coeffs, dtype=np.float32)
    n = c.shape[0]
    offsets: List[int] = []
    weights: List[np.ndarray] = []
    for k in range(n):
        w = c[np.arange(n), (np.arange(n) + k) % n]
        if np.any(w != 0):
            offsets.append(k)
            weights.append(w)
    return CirculantSchedule(offsets, np.stack(weights), n)


def sparse_offsets(support: np.ndarray) -> Tuple[int, ...]:
    """Distinct ring offsets covering a 0/1 support mask (adjacency plus
    self-loops): offset k is needed iff any ``support[i, (i+k) % n] > 0``."""
    s = np.asarray(support)
    n = s.shape[0]
    rows = np.arange(n)
    return tuple(k for k in range(n)
                 if np.any(s[rows, (rows + k) % n] > 0))


def _roll_sum(leaf: torch.Tensor, offsets, weights,
              acc_dtype) -> torch.Tensor:
    """``Σ_k w_k[i] · leaf[(i + k) % n]`` in ascending offset order, from
    0, in ``acc_dtype``; cast back to the leaf's dtype."""
    n = leaf.shape[0]
    extra = (1,) * (leaf.ndim - 1)
    acc = torch.zeros(leaf.shape, dtype=acc_dtype, device=leaf.device)
    for k, w in zip(offsets, weights):
        # destination i receives source (i + k) % n: a roll by -k
        shifted = torch.roll(leaf, -k, 0) if k else leaf
        acc = acc + w.to(acc_dtype).reshape((n,) + extra) * \
            shifted.to(acc_dtype)
    return acc.to(leaf.dtype)


def mix_sparse(params, coeffs: torch.Tensor, offsets: Sequence[int],
               mix_in_float32: bool = True):
    """Circulant gossip with static ``offsets`` and weights
    ``w_k[i] = coeffs[i, (i + k) % n]`` gathered from the live matrix, so
    one schedule serves every round.  Weight outside the offset set is
    dropped: callers derive the offsets from the nominal support.  f32
    accumulation, or the leaf dtype with ``mix_in_float32=False``."""
    c = coeffs.to(torch.float32)
    n = c.shape[0]
    rows = torch.arange(n, device=c.device)
    weights = [c[rows, (rows + k) % n] for k in offsets]
    return tree_util.tree_map(
        lambda leaf: _roll_sum(
            leaf, offsets, weights,
            torch.float32 if mix_in_float32 else leaf.dtype), params)


def mix_sparse_host(params, schedule: CirculantSchedule):
    """Single-host reference of a :class:`CirculantSchedule`: its f32
    weights, f32 accumulation."""
    def leaf_fn(leaf):
        weights = [torch.as_tensor(w, device=leaf.device)
                   for w in schedule.weights]
        return _roll_sum(leaf, schedule.offsets, weights, torch.float32)

    return tree_util.tree_map(leaf_fn, params)


def mixing_collective_bytes(n_nodes: int, param_bytes_per_node: int,
                            schedule: CirculantSchedule = None) -> dict:
    """Bytes a node receives per mix on a ring of devices: the dense
    all-gather ``(n - 1)·P``, and with a schedule one permute per nonzero
    offset, ``K'·P``."""
    out = {"dense_bytes_per_node": (n_nodes - 1) * param_bytes_per_node}
    if schedule is not None:
        nonzero = sum(1 for o in schedule.offsets if o != 0)
        out["sparse_bytes_per_node"] = nonzero * param_bytes_per_node
        out["sparse_offsets"] = nonzero
    return out


def edge_weights(coeffs: torch.Tensor, nbr_idx: torch.Tensor,
                 nbr_mask: torch.Tensor) -> torch.Tensor:
    """Per-edge coefficients ``w[i, d] = coeffs[i, nbr_idx[i, d]]``, zero
    on padding slots: the ``(n, dmax)`` operand of the edge-list mix
    (``(E, n, dmax)`` for ``(E, n, n)`` coefficients)."""
    rows = torch.arange(coeffs.shape[-2], device=coeffs.device)[:, None]
    return coeffs[..., rows, nbr_idx.long()] * nbr_mask.to(coeffs.dtype)


def mix_edges(params, coeffs: torch.Tensor, nbr_idx: torch.Tensor,
              nbr_mask: torch.Tensor, mix_in_float32: bool = True):
    """Edge-list gossip: ``out[i] = Σ_d w[i, d] · leaf[nbr_idx[i, d]]``
    over every leaf — agrees with :func:`mix_dense` to 1e-6."""
    idx = nbr_idx.long()
    w = edge_weights(coeffs.to(torch.float32), idx, nbr_mask)

    def leaf_fn(leaf):
        acc_dtype = torch.float32 if mix_in_float32 else leaf.dtype
        gathered = leaf.to(acc_dtype)[idx]               # (n, dmax, ...)
        wk = w.to(acc_dtype).reshape(w.shape + (1,) * (leaf.ndim - 1))
        return (wk * gathered).sum(dim=1).to(leaf.dtype)

    return tree_util.tree_map(leaf_fn, params)


# ----------------------------------------------------------------------
# robust aggregation: coordinate-wise order statistics over neighbours
# ----------------------------------------------------------------------
def oddeven_sort_pairs(keys: torch.Tensor, vals: torch.Tensor):
    """Sort ``(keys, vals)`` ascending by ``keys`` along dim 0 with the
    reference's odd-even transposition network: ``d`` passes of
    compare-exchanges that swap only on ``lo > hi``, so the sort is
    stable and its output is the unique stable order.  Keys must be
    finite (see :func:`robust_combine`)."""
    keys, vals = keys.clone(), vals.clone()
    d = keys.shape[0]
    for p in range(d):
        start = p % 2
        npairs = (d - start) // 2
        if npairs == 0:
            continue
        stop = start + 2 * npairs
        lo, hi = slice(start, stop, 2), slice(start + 1, stop, 2)
        swap = keys[lo] > keys[hi]
        for t in (keys, vals):
            a, b = t[lo], t[hi]
            t[lo], t[hi] = torch.where(swap, b, a), torch.where(swap, a, b)
    return keys, vals


def robust_combine(vals: torch.Tensor, w: torch.Tensor,
                   self_vals: torch.Tensor, op: str,
                   trim_k: int = 1) -> torch.Tensor:
    """Coordinate-wise robust aggregate of gathered neighbour rows.

    vals: ``(d, m, t)``, slot d's value for destination m, coordinate t,
    in the accumulation dtype; w: ``(d, m)`` slot weights (a slot takes
    part iff w > 0); self_vals: ``(m, t)``, each destination's own row,
    the fallback when nothing survives.  ``op="trimmed"`` drops the
    ``trim_k`` smallest and largest occupied values and takes the
    weight-renormalised mean of the rest; ``op="median"`` takes the
    unweighted median of the occupied values.  NaN/±Inf are clamped to
    ±1e30 first.  Every product and sum is its own rounded op in the
    dtype of ``vals``, in ascending sorted slot order — the arithmetic of
    the CUDA kernel, op for op."""
    if op not in ("trimmed", "median"):
        raise ValueError(f"robust_combine op {op!r} not in "
                         f"('trimmed', 'median')")
    dt = vals.dtype
    valid = (w > 0)[:, :, None]
    # filled on the device: a tensor built from a Python scalar on the
    # card is a pageable copy, which waits for the stream
    full = lambda v: torch.full((), v, dtype=dt, device=vals.device)
    big = full(_ROBUST_BIG)
    keys = torch.nan_to_num(vals, nan=_ROBUST_BIG, posinf=_ROBUST_BIG,
                            neginf=-_ROBUST_BIG).clamp(-big, big)
    keys = torch.where(valid, keys, full(_ROBUST_PAD))
    w3 = torch.where(valid, w[:, :, None], torch.zeros((), dtype=dt,
                                                       device=vals.device))
    keys, w3 = oddeven_sort_pairs(keys, w3.to(dt).expand(keys.shape))
    occupied = w3 > 0
    r_lo = torch.cumsum(occupied.to(torch.int32), 0)  # 1-based rank
    cnt = r_lo[-1]
    if op == "median":
        lo = ((cnt - 1) // 2).clamp_min(0)[None].long()
        med = keys.gather(0, lo)[0] + keys.gather(0, (cnt // 2)[None].long())[0]
        return torch.where(cnt > 0, 0.5 * med, self_vals)
    r_hi = cnt[None] - r_lo + occupied.to(torch.int32)
    keep = occupied & (r_lo > trim_k) & (r_hi > trim_k)
    wk = torch.where(keep, w3, torch.zeros((), dtype=dt, device=vals.device))
    mass = torch.zeros(keys.shape[1:], dtype=dt, device=vals.device)
    num = torch.zeros_like(mass)
    for i in range(keys.shape[0]):
        mass = mass + wk[i]
        num = num + wk[i] * keys[i]
    safe = torch.where(mass > 0, mass, torch.ones_like(mass))
    return torch.where(mass > 0, num / safe, self_vals)


def mix_robust_tables(params, coeffs: torch.Tensor, nbr_idx: torch.Tensor,
                      nbr_mask: torch.Tensor, op: str, trim_k: int = 1,
                      mix_in_float32: bool = True):
    """Robust Eq. (2) over the padded-ELL tables, leaf by leaf: the
    weighted mean replaced by :func:`robust_combine` over each
    destination's slots (self included; slots whose weight is 0 —
    padding, dropped or quarantined columns — take no part).  Gathers an
    ``(dmax, n, |leaf|)`` tensor per leaf: a plain version, not a
    kernel (``mix_impl="edges"`` runs the kernel)."""
    if coeffs.ndim == 3:
        return per_experiment(mix_robust_tables, params, coeffs, nbr_idx,
                              nbr_mask, op, trim_k, mix_in_float32)
    idx = nbr_idx.long()
    w = edge_weights(coeffs.to(torch.float32), idx, nbr_mask)
    n = idx.shape[0]

    def leaf_fn(leaf):
        acc_dtype = torch.float32 if mix_in_float32 else leaf.dtype
        flat = leaf.reshape(n, -1).to(acc_dtype)
        out = robust_combine(flat[idx.T], w.T.to(acc_dtype), flat, op,
                             trim_k=trim_k)
        return out.to(leaf.dtype).reshape(leaf.shape)

    return tree_util.tree_map(leaf_fn, params)


def plane_norms(params, batch_dims: int = 1) -> torch.Tensor:
    """f32 L2 norm of each node's whole parameter row, ``(n,)`` (or the
    leaves' first ``batch_dims`` axes, ``(E, n)`` for a sweep's trees):
    what the ``norm_clip`` rule and the quarantine screen compare."""
    leaves = tree_util.leaves(params)
    lead = tuple(leaves[0].shape[:batch_dims])
    sq = torch.zeros(lead, dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        flat = leaf.reshape(lead + (-1,)).to(torch.float32)
        sq = sq + (flat * flat).sum(dim=-1)
    return torch.sqrt(sq)


def norm_clip_coeffs(coeffs: torch.Tensor, norms: torch.Tensor,
                     clip_mult: float = 1.0) -> torch.Tensor:
    """Row-norm clipping as a coefficient transform: neighbour j's weight
    in row i is scaled by ``min(1, clip_mult·‖x_i‖/‖x_j‖)``.  Neighbours
    with nonfinite norms are dropped, zero-norm neighbours pass
    unclipped, self weights are never clipped; rows that changed are
    renormalised (fallback self-weight 1) and rows left untouched come
    back BIT-identical, so a round where nothing clips is the plain mean
    exactly.  ``coeffs`` ``(E, n, n)`` takes ``(E, n)`` norms."""
    c = coeffs
    n = c.shape[-1]
    norms = norms.to(torch.float32)
    denom = torch.where(norms > 0, norms, torch.ones_like(norms))
    ratio = float(clip_mult) * norms[..., :, None] / denom[..., None, :]
    one = torch.ones((), dtype=torch.float32, device=c.device)
    factor = torch.where(norms[..., None, :] > 0, torch.minimum(ratio, one),
                         one)
    factor = torch.where(torch.isfinite(factor), factor, one)
    factor = torch.where(torch.isfinite(norms)[..., None, :], factor,
                         torch.zeros_like(factor))
    eye = torch.eye(n, dtype=torch.bool, device=c.device)
    factor = torch.where(eye, one, factor).to(c.dtype)
    scaled = c * factor
    changed = (scaled != c).any(dim=-1, keepdim=True)
    return torch.where(changed, renormalize_rows(scaled), c)
