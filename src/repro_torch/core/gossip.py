"""Distributed gossip: Eq. (2) as collectives over a process group (port
of ``repro/core/gossip.py``).

The reference runs these inside ``shard_map`` with the stacked node axis
sharded over a mesh axis.  The port runs one process a rank: every leaf
``(n, ...)`` is split into contiguous blocks of ``n_local = n / world``
rows, rank r holding rows ``[r·n_local, (r+1)·n_local)``, and each
function takes this rank's block and a ``torch.distributed`` group.  The
leaves are packed once into one ``(n_local, P)`` plane
(``core.plane.PlaneLayout``), so a mix moves one buffer whatever the leaf
count:

* :func:`gossip_dense` — one all-gather of the plane to ``(n, P)``, then
  this rank's rows of C contracted with it in f32 by the hand-written
  ``gossip_mix`` kernel (``kernels.gossip_mix``): one launch a mix;
* :func:`gossip_sparse` — the circulant schedule: each ring offset is a
  shift of the node axis across ranks, two ``batch_isend_irecv`` pairs
  (shifts q and q + 1) and a slice-and-concat, accumulated in f32 in
  ascending offset order;
* :func:`pod_gossip` — the inter-pod tier: an all-gather over the pod
  group, then ``pod_coeffs[me] · pods`` through ``gossip_mix``.

:func:`make_gossip_fn` binds them to a ``DeviceMesh`` axis.  On the card
the group is NCCL and the planes stay on the device; a CUDA tensor never
goes through gloo.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.mixing import CirculantSchedule
from repro_torch.core.plane import PlaneLayout
from repro_torch.kernels.gossip_mix import gossip_mix

__all__ = ["gossip_dense", "gossip_sparse", "pod_gossip", "make_gossip_fn"]


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``out`` (world·rows, ...) ← every rank's ``x`` (rows, ...), in rank
    order: ``all_gather_single`` where torch has it (its
    ``all_gather_into_tensor`` is deprecated there), else
    ``all_gather_into_tensor``."""
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _packed(params):
    """``(layout, rows)``: the tree packed into a plane whose rows start on
    16-byte boundaries, and the plane's whole ``(n_local, ld)`` buffer
    (padding columns included), contiguous for a collective.  The mixes
    run over all ``ld`` columns, whose 16-byte multiple lets ``gossip_mix``
    take its vector path whatever P; the padding columns' results are
    dropped."""
    layout = PlaneLayout.from_tree(params)
    plane = layout.pack(params)
    ld = plane.stride(0)
    return layout, plane.as_strided((plane.shape[0], ld), (ld, 1))


def gossip_dense(params, coeffs_rows: torch.Tensor, group=None):
    """Dense gossip over ``group``: ``params`` leaves ``(n_local, ...)``
    (this rank's block of the node axis), ``coeffs_rows`` ``(n_local, n)``
    (this rank's rows of C).  One all-gather of the packed plane, one
    ``gossip_mix`` launch (blocks ``(n, 1, P)``, weights ``(n_local,
    n)``) summing in f32, each leaf cast back to its dtype."""
    layout, rows = _packed(params)
    world = dist.get_world_size(group)
    full = torch.empty((world * rows.shape[0], rows.shape[1]),
                       dtype=rows.dtype, device=rows.device)
    _all_gather(full, rows, group)
    n = full.shape[0]
    if coeffs_rows.shape[-1] != n:
        raise ValueError(f"coeffs_rows {tuple(coeffs_rows.shape)} for "
                         f"{n} gathered nodes")
    mixed = gossip_mix(full.unsqueeze(1),
                       coeffs_rows.to(torch.float32))   # (n_local, 1, ld)
    return layout.unpack(mixed.squeeze(1)[:, :layout.n_params])


def _shift(x: torch.Tensor, shift: int, group) -> torch.Tensor:
    """Rank s receives rank ``(s + shift) % world``'s ``x``; a shift that
    is a multiple of the world is ``x`` itself (no self-send)."""
    world = dist.get_world_size(group)
    if shift % world == 0:
        return x
    me = dist.get_rank(group)
    out = torch.empty_like(x)
    peer = lambda r: dist.get_global_rank(group, r % world) \
        if group is not None else r % world
    ops = [dist.P2POp(dist.isend, x, peer(me - shift), group),
           dist.P2POp(dist.irecv, out, peer(me + shift), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def _shard_roll(x: torch.Tensor, k: int, group) -> torch.Tensor:
    """Distributed ``roll(x, -k, 0)`` of a node axis split in contiguous
    blocks of ``n_local`` rows: destination node i takes source node
    ``(i + k) mod n``, so a destination block spans at most two source
    blocks, shifted by q and q + 1 where ``q, r = divmod(k, n_local)``."""
    n_local = x.shape[0]
    world = dist.get_world_size(group)
    q, r = divmod(k % (n_local * world), n_local)
    a = _shift(x, q, group)
    if r == 0:
        return a
    b = _shift(x, q + 1, group)
    return torch.cat([a[r:], b[:r]], dim=0)


def gossip_sparse(params, schedule: CirculantSchedule,
                  weights_local: torch.Tensor, group=None):
    """Circulant gossip over ``group``: ``params`` leaves ``(n_local,
    ...)``, ``weights_local`` ``(K, n_local)`` — this rank's columns of the
    schedule's per-destination weights.  ``Σ_k w_k[i] · x[(i + k) % n]``
    in f32, in ascending offset order from zero (``core.mixing``'s
    ``_roll_sum``), cast back to each leaf's dtype."""
    layout, rows = _packed(params)
    x = rows[:, :layout.n_params]
    w = weights_local.to(device=x.device, dtype=torch.float32)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for idx, k in enumerate(schedule.offsets):
        shifted = _shard_roll(rows, k, group)[:, :layout.n_params]
        acc = acc + w[idx].reshape(-1, 1) * shifted.to(torch.float32)
    return layout.unpack(acc)


def pod_gossip(params, pod_coeffs: torch.Tensor, group=None):
    """Inter-pod mixing, each pod one super-node: every leaf averaged
    across the pods at the same intra-pod position,
    ``leaf'_p = Σ_q pod_coeffs[p, q] · leaf_q``, with ``group`` the ranks
    of this position in every pod, in pod order.  One all-gather, one
    ``gossip_mix`` launch (f32 sums)."""
    layout, rows = _packed(params)
    pods = dist.get_world_size(group)
    full = torch.empty((pods * rows.shape[0], rows.shape[1]),
                       dtype=rows.dtype, device=rows.device)
    _all_gather(full, rows, group)
    me = dist.get_rank(group)
    w = torch.as_tensor(pod_coeffs)[me].to(device=rows.device,
                                           dtype=torch.float32)
    mixed = gossip_mix(full.unflatten(0, (pods, -1)), w)   # (n_local, ld)
    return layout.unpack(mixed[:, :layout.n_params])


def make_gossip_fn(mesh, n_nodes: int,
                   schedule: Optional[CirculantSchedule] = None,
                   node_axis: str = "data",
                   param_spec: Sequence[Optional[str]] = ()):
    """``fn(params, coeffs) -> params`` over ``mesh``'s ``node_axis``
    (a ``torch.distributed.device_mesh.DeviceMesh``).

    ``params`` leaves are this rank's block ``(n / |node_axis|, ...)`` of
    the node axis.  Dense (no ``schedule``): ``coeffs`` is this rank's rows
    of the ``(n, n)`` matrix; sparse: this rank's columns of the schedule's
    ``(K, n)`` weights.  ``param_spec`` names the other mesh dims that
    split the weight dims (the reference's ``P(node_axis, *param_spec)``):
    each rank then holds a shard of every leaf's weight dims, and the
    gossip runs over the node-axis subgroup at this rank's coordinates on
    the other dims — Eq. (2) mixes each weight entry alone, so the shards
    mix independently."""
    names = tuple(mesh.mesh_dim_names or ())
    if node_axis not in names:
        raise ValueError(f"mesh has no axis {node_axis!r}: {names}")
    for axis in param_spec:
        if axis is not None and (axis == node_axis or axis not in names):
            raise ValueError(f"param_spec axis {axis!r} must be another "
                             f"dim of the mesh {names}")
    axis_size = mesh.size(names.index(node_axis))
    if n_nodes % axis_size != 0:
        raise ValueError(
            f"n_nodes={n_nodes} not divisible by |{node_axis}|={axis_size}")
    group = mesh.get_group(node_axis)
    if schedule is None:
        return lambda params, coeffs: gossip_dense(params, coeffs, group)
    return lambda params, coeffs: gossip_sparse(params, schedule, coeffs,
                                                group)
