"""Apply a mixing matrix to a stacked model tree (port of the dense and
edge-list schedules of ``repro/core/mixing.py``).

Eq. (2), ``m_i ← Σ_j C[i, j] · m_j``, over trees whose leaves carry a
leading node axis ``(n, ...)``:

* :func:`mix_dense` — every leaf contracted against the dense (n, n)
  matrix (``mix_impl="einsum"``; a plain matrix product per leaf, left to
  the library as the reference leaves it to XLA);
* :func:`mix_edges` — the padded-ELL gather-accumulate over static
  neighbour tables with per-edge weights gathered from the live matrix
  (:func:`edge_weights`).

Both accumulate in f32 by default; ``mix_in_float32=False`` accumulates
in the leaf dtype (the low-precision-aggregation ablation).  The circulant
``mix_sparse`` schedule waits for a later slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import torch

from repro_torch import tree as tree_util

__all__ = ["mix_dense", "edge_weights", "mix_edges"]


def _leaf_mix(c: torch.Tensor, leaf: torch.Tensor,
              mix_in_float32: bool = True) -> torch.Tensor:
    acc_dtype = torch.float32 if mix_in_float32 else leaf.dtype
    n = leaf.shape[0]
    acc = c.to(acc_dtype) @ leaf.reshape(n, -1).to(acc_dtype)
    return acc.reshape(leaf.shape).to(leaf.dtype)


def mix_dense(params, coeffs: torch.Tensor, mix_in_float32: bool = True):
    """Dense gossip: every leaf ``(n, ...)`` contracted against the
    ``(n, n)`` matrix."""
    return tree_util.tree_map(
        lambda leaf: _leaf_mix(coeffs, leaf, mix_in_float32), params)


def edge_weights(coeffs: torch.Tensor, nbr_idx: torch.Tensor,
                 nbr_mask: torch.Tensor) -> torch.Tensor:
    """Per-edge coefficients ``w[i, d] = coeffs[i, nbr_idx[i, d]]``, zero
    on padding slots: the ``(n, dmax)`` operand of the edge-list mix."""
    rows = torch.arange(coeffs.shape[0], device=coeffs.device)[:, None]
    return coeffs[rows, nbr_idx.long()] * nbr_mask.to(coeffs.dtype)


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
