"""Flat parameter plane (port of ``repro/core/plane.py``).

A stacked node-model tree (every leaf ``(n, ...)``) packed into ONE
``(n, P)`` buffer so Eq. (2) is a single ``C @ plane`` whatever the leaf
count.  Columns follow ``jax.tree`` leaf order (dict keys sorted, lists in
order — ``repro_torch.tree``), so the port's plane is column-for-column the
reference's: the FFN's ``l1.b`` comes before ``l1.w``, and VGG's five
``{"pool": ()}`` marker leaves take one column each inside ``convs``.

Storage: :meth:`PlaneLayout.pack` writes into an ``(n, ld)`` buffer whose
row stride ``ld`` is ``P`` rounded up to 16 bytes and returns the
``(n, P)`` view, so every row starts 16-byte aligned and the gossip
kernels can read it with 16-byte vector loads whatever P is (P is odd for
VGG-16).  :meth:`unpack` returns views into the plane (the reference
copies), each leaf in its own shape and dtype.

Dtype policy: the plane dtype defaults to the widest leaf dtype
(``torch.promote_types`` over the leaves — f32 as soon as any leaf is
f32); pass ``torch.bfloat16`` to halve the plane's bytes.

The serving tier's bridge is :meth:`PlaneLayout.pack_row`: one node's
freshly mixed params become its serving weights by a write into its
plane row (``FleetScheduler.swap_node``), in place, so every view that
:meth:`unpack` handed out sees them.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch import tree as tree_util

__all__ = ["LeafSlot", "PlaneLayout", "aligned_plane"]

_ALIGN_BYTES = 16


def aligned_plane(n: int, p: int, dtype, device) -> torch.Tensor:
    """Uninitialized ``(n, p)`` view of an ``(n, ld)`` buffer whose rows
    start on 16-byte boundaries."""
    step = max(1, _ALIGN_BYTES // torch.empty((), dtype=dtype).element_size())
    ld = -(-max(p, 1) // step) * step
    return torch.empty((n, ld), dtype=dtype, device=device)[:, :p]


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """One leaf's column range inside the plane."""

    shape: Tuple[int, ...]   # trailing shape (node axis stripped)
    dtype: Any               # the leaf's own dtype (restored by unpack)
    offset: int              # first plane column
    size: int                # prod(shape), ≥ 1


@dataclasses.dataclass(frozen=True)
class PlaneLayout:
    """Static packing plan for a stacked tree with leading node axis n."""

    treedef: Any
    slots: Tuple[LeafSlot, ...]
    n_nodes: int

    @property
    def n_params(self) -> int:
        """P — plane columns (per-node parameter count over all leaves)."""
        return 0 if not self.slots else (self.slots[-1].offset
                                         + self.slots[-1].size)

    def plane_nbytes(self, dtype: Optional[Any] = None) -> int:
        """Bytes of one packed ``(n, P)`` plane in ``dtype`` (None → the
        widest leaf dtype), row padding not counted."""
        dtype = self.widest_dtype if dtype is None else dtype
        return (self.n_nodes * self.n_params
                * torch.empty((), dtype=dtype).element_size())

    @property
    def widest_dtype(self):
        return functools.reduce(torch.promote_types,
                                [s.dtype for s in self.slots])

    @classmethod
    def from_tree(cls, params) -> "PlaneLayout":
        leaves, treedef = tree_util.flatten(params)
        if not leaves:
            raise ValueError("PlaneLayout.from_tree: empty tree")
        n = leaves[0].shape[0]
        slots, offset = [], 0
        for leaf in leaves:
            if leaf.ndim < 1 or leaf.shape[0] != n:
                raise ValueError(
                    f"stacked tree leaves must share the leading node axis; "
                    f"got shapes {[tuple(l.shape) for l in leaves]}")
            size = math.prod(leaf.shape[1:])
            slots.append(LeafSlot(tuple(leaf.shape[1:]), leaf.dtype, offset,
                                  size))
            offset += size
        return cls(treedef, tuple(slots), n)

    def _check_tree(self, params) -> list:
        leaves, treedef = tree_util.flatten(params)
        if treedef != self.treedef or any(
                tuple(l.shape) != (self.n_nodes,) + s.shape
                for l, s in zip(leaves, self.slots)):
            raise ValueError(
                f"PlaneLayout mismatch: layout packs leaf shapes "
                f"{[(self.n_nodes,) + s.shape for s in self.slots]}, got "
                f"{[tuple(l.shape) for l in leaves]}")
        return leaves

    def pack(self, params, dtype: Optional[Any] = None) -> torch.Tensor:
        """Stacked tree → ``(n, P)`` plane (row stride aligned to 16 B)."""
        dtype = self.widest_dtype if dtype is None else dtype
        leaves = self._check_tree(params)
        plane = aligned_plane(self.n_nodes, self.n_params, dtype,
                              leaves[0].device)
        for leaf, s in zip(leaves, self.slots):
            plane[:, s.offset:s.offset + s.size].copy_(
                leaf.reshape(self.n_nodes, s.size))
        return plane

    def pack_row(self, params_one, dtype: Optional[Any] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ONE node's tree (no leading node axis) → ``(P,)`` row, written
        leaf by leaf into ``out`` (a plane row, in place) when given;
        ``out`` must be ``(P,)`` in ``dtype``."""
        dtype = self.widest_dtype if dtype is None else dtype
        leaves, treedef = tree_util.flatten(params_one)
        if treedef != self.treedef or any(
                tuple(l.shape) != s.shape for l, s in zip(leaves, self.slots)):
            raise ValueError(
                f"PlaneLayout.pack_row: layout packs leaf shapes "
                f"{[s.shape for s in self.slots]}, got "
                f"{[tuple(l.shape) for l in leaves]}")
        if out is not None and (tuple(out.shape) != (self.n_params,)
                                or out.dtype != dtype):
            raise ValueError(
                f"PlaneLayout.pack_row: out must be ({self.n_params},) "
                f"{dtype}, got {tuple(out.shape)} {out.dtype}")
        row = out if out is not None else torch.empty(
            (self.n_params,), dtype=dtype, device=leaves[0].device)
        for leaf, s in zip(leaves, self.slots):
            row[s.offset:s.offset + s.size].copy_(leaf.reshape(-1))
        return row

    def unpack_row(self, row: torch.Tensor):
        """``(P,)`` row → one node's tree of views (inverse of
        :meth:`pack_row`; a dtype cast copies)."""
        if row.shape[-1] != self.n_params:
            raise ValueError(
                f"PlaneLayout.unpack_row: row has {row.shape[-1]} columns, "
                f"layout packs {self.n_params}")
        leaves = [row[s.offset:s.offset + s.size].reshape(s.shape).to(s.dtype)
                  for s in self.slots]
        return tree_util.unflatten(self.treedef, leaves)

    def unpack(self, plane: torch.Tensor):
        """``(n, P)`` plane → stacked tree of views, each leaf in its own
        shape and dtype (a cast copies)."""
        if plane.shape[-1] != self.n_params:
            raise ValueError(
                f"PlaneLayout.unpack: plane has {plane.shape[-1]} columns, "
                f"layout packs {self.n_params}")
        leaves = [
            plane[:, s.offset:s.offset + s.size]
            .reshape((self.n_nodes,) + s.shape).to(s.dtype)
            for s in self.slots
        ]
        return tree_util.unflatten(self.treedef, leaves)
