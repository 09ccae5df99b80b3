"""Ranks, process groups and meshes (port of ``repro/launch/mesh.py``).

The reference lays its meshes over the devices one JAX process sees.  The
port runs one process a rank (``torchrun`` / ``python -m
torch.distributed.run``, or ``torch.multiprocessing.spawn`` in the tests),
so a mesh is a set of ranks with its process groups:

* :func:`init_distributed` joins the world (``RANK``/``WORLD_SIZE``/
  ``LOCAL_RANK`` under ``torchrun``; a world of 1 otherwise) and returns
  the rank's device;
* :func:`make_sweep_mesh` — the sweep engine's 1-D experiment axis over
  the first n ranks, with a gloo group for the engine's one gather of its
  results (``SweepEngine.run(mesh=...)``), so ranks may share one card;
* :func:`make_training_mesh` / :func:`make_production_mesh` — the
  reference's ``(pod, node, fsdp, model)`` and ``(pod,) data, model``
  shapes as a ``torch.distributed.device_mesh.DeviceMesh``, built only
  when the world has exactly that many ranks.  :func:`training_mesh_shape`
  and :func:`production_mesh_shape` give the shapes and axis names
  without a world.

Importing this module initializes nothing.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device

__all__ = ["init_distributed", "SweepMesh", "make_sweep_mesh",
           "training_mesh_shape", "production_mesh_shape",
           "make_training_mesh", "make_production_mesh", "POD_DATA",
           "POD_MODEL"]

POD_DATA = 16
POD_MODEL = 16


def init_distributed(device=None) -> torch.device:
    """Join the process group and return this rank's device.

    Under ``torchrun`` the rank, world size and master address come from
    the environment (``env://``); outside it the world is this process
    alone, over an in-process store.  A group another caller initialized
    (the tests' ``FileStore``) is kept.  The backend is NCCL on the card
    and gloo only for ``device="cpu"``; a card rank's device is
    ``cuda:{LOCAL_RANK % device_count}``, so several ranks may share one
    card.  ``device=None`` is the card and raises without one."""
    dev = resolve_device(device)
    backend = "gloo" if dev.type == "cpu" else "nccl"
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    elif dev.type == "cuda" and dist.get_backend() != "nccl":
        raise RuntimeError(
            f"the process group runs {dist.get_backend()!r}; a CUDA rank "
            "needs NCCL (a CUDA tensor never goes through gloo)")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


@dataclasses.dataclass(frozen=True)
class SweepMesh:
    """The experiment axis over ``ranks`` (the first ``size`` ranks of the
    world), with their gloo ``group``; ``index`` is this rank's place on
    the axis, -1 for a rank outside it."""

    axis_name: str
    ranks: Tuple[int, ...]
    group: object
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


_SWEEP_MESHES = itertools.count()


def _store_barrier(key: str) -> None:
    """Every rank of the world waits until all have reached ``key``, over
    the default group's store: no collective, since ranks sharing one
    card cannot form an NCCL communicator."""
    store = dist.distributed_c10d._get_default_store()
    if store.add(key, 1) == dist.get_world_size():
        store.set(key + "/all", "1")
    store.wait([key + "/all"])


def make_sweep_mesh(n_devices: Optional[int] = None,
                    axis_name: str = "exp") -> SweepMesh:
    """1-D mesh over the sweep engine's experiment axis: the first
    ``n_devices`` ranks (default: all).  Every rank of the world calls it
    (a group is created collectively).  Its group is gloo whatever device
    the ranks compute on: the engine gathers its results once, on host
    copies, so ranks may share one card."""
    if not dist.is_initialized():
        raise RuntimeError("make_sweep_mesh needs a process group: call "
                           "repro_torch.launch.mesh.init_distributed first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(
            f"a sweep mesh of {n} ranks in a world of {world}: launch "
            f"with torchrun --nproc-per-node {n} (or more)")
    ranks = tuple(range(n))
    group = dist.new_group(list(ranks), backend="gloo")
    if n < world:
        # gloo connects the members inside ``new_group``; a rank outside
        # the group that left now (and tore its connections down) can
        # break that connect, so the world waits for it here
        _store_barrier(f"repro_torch/sweep_mesh/{next(_SWEEP_MESHES)}")
    rank = dist.get_rank()
    return SweepMesh(axis_name, ranks, group,
                     ranks.index(rank) if rank in ranks else -1)


def training_mesh_shape(n_nodes: int = 16, *, tp: int = POD_MODEL,
                        multi_pod: bool = False
                        ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``(shape, axis names)`` of the gossip-aware mesh ``(pod, node,
    fsdp, model)``: ``n_nodes`` topology nodes a pod, ``tp`` the tensor
    parallel degree, ``fsdp = 256 // (n_nodes · tp)``; 256 ranks a pod,
    512 with ``multi_pod``."""
    chips = POD_DATA * POD_MODEL
    if chips % (n_nodes * tp) != 0:
        raise ValueError(
            f"n_nodes·tp = {n_nodes}·{tp} must divide pod size {chips}")
    fsdp = chips // (n_nodes * tp)
    pods = 2 if multi_pod else 1
    return (pods, n_nodes, fsdp, tp), ("pod", "node", "fsdp", "model")


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``(shape, axis names)`` of the canonical ``(data, model)`` mesh,
    ``(pod, data, model)`` with ``multi_pod``."""
    if multi_pod:
        return (2, POD_DATA, POD_MODEL), ("pod", "data", "model")
    return (POD_DATA, POD_MODEL), ("data", "model")


def _device_mesh(shape, names):
    """A ``DeviceMesh`` of ``shape`` over the whole world, which must have
    exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs a process group: call "
                           "repro_torch.launch.mesh.init_distributed first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise RuntimeError(
            f"mesh {dict(zip(names, shape))} needs {math.prod(shape)} "
            f"ranks; the world has {world}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(names))


def make_training_mesh(n_nodes: int = 16, *, tp: int = POD_MODEL,
                       multi_pod: bool = False):
    """The gossip-aware ``(pod, node, fsdp, model)`` mesh
    (:func:`training_mesh_shape`) over the world."""
    return _device_mesh(*training_mesh_shape(n_nodes, tp=tp,
                                             multi_pod=multi_pod))


def make_production_mesh(*, multi_pod: bool = False):
    """The canonical production mesh (:func:`production_mesh_shape`) over
    the world."""
    return _device_mesh(*production_mesh_shape(multi_pod=multi_pod))
