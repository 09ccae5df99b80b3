"""Decentralized learning runtime — Algorithm 1 of the paper (port of
``repro/core/decentralized.py``).

All n node-models are held as ONE stacked tree (leaves ``(n, ...)``).
Each round:

  1. **LocalTrain** (Eq. 1): every node runs E epochs of minibatch SGD/Adam
     on its own data shard — ``torch.func.vmap`` of ``grad_and_value``
     over the node axis, a Python loop over the batches (the reference's
     ``lax.scan``);
  2. **Aggregation** (Eq. 2): the stacked params are mixed with the
     strategy's row-stochastic matrix by the backend ``mix_impl`` names:
     ``"einsum"`` (a library matrix product per leaf), ``"pallas"`` (the
     fused flat-plane CUDA kernel, ``kernels.gossip_mix.mix_plane`` — the
     name is kept from the reference so configs carry over), ``"edges"``
     (the padded edge-list CUDA kernel, ``kernels.gossip_mix.
     mix_edges_kernel``) or ``"sparse"`` (the circulant ring-offset
     schedule, ``core.mixing.mix_sparse``, which falls back to
     ``"einsum"`` where the support needs more offsets than its max degree
     plus ``sparse_slack``: :func:`sparse_schedule`).

:meth:`DecentralizedTrainer.run` and :meth:`run_unrolled` are both a
Python loop over rounds with evaluation only on :func:`eval_round_indices`;
they differ in where the per-round matrices come from (one precomputed
``(R, n, n)`` stack vs one matrix per round) and give the same history.

The Byzantine layer (DESIGN.md §16): ``DecentralizedConfig(robust=...)``
swaps Eq. (2)'s weighted mean for a coordinate-wise trimmed mean or median
(``mix_impl="einsum"``: the plain ``core.mixing.mix_robust_tables``;
``"edges"``: the robust CUDA kernel ``kernels.gossip_mix.
mix_robust_kernel``) or clips neighbour weights by row norm
(``"norm_clip"``, in front of any backend).  :func:`make_fault_round_fn`
injects faults into the published plane with an optional quarantine
screen, and :func:`make_participation_round_fn` lets only a drawn subset
of nodes train and gossip each round; both draw their per-round masks
from the port's JAX-compatible threefry (``core.prng``), so the masks
equal the reference's.

The sweep engine (``core.sweep``) runs the same round functions over E
experiments at once: its trees carry a leading experiment axis (leaves
``(E, n, ...)``), its matrices are ``(E, n, n)``, and a participation or
fault carry holds ``(E,)`` rates and seeds.  A round function sees the
axis in ``coeffs.ndim == 3``: LocalTrain folds E into the node axis
(``(E·n, ...)`` through the same ``torch.func.vmap``), the masks are drawn
for each experiment (``(E, n)``), and the mix backends take the batched
operands in one pack and one launch.  :func:`make_scan_fn` is the round
loop shared by the engine's modes.

Mixing matrices come from the f32 coefficient program for its kinds
(``core/coeffs.py``) and from the float64 host path
(``core.strategies.mixing_matrix``, cast to f32) for the others
(``metropolis``), as the reference's ``round_coeffs`` does; a
``coeffs_fn(round) -> matrix`` given to the trainer (link-failure
schedules, a program with ``p_fail > 0``) overrides both.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, to_device
from repro_torch import tree as tree_util
from repro_torch.core.coeffs import (
    PROGRAM_KINDS,
    participation_renormalize,
    program_for,
    quarantine_renormalize,
)
from repro_torch.core.mixing import (
    ROBUST_MODES,
    mix_dense,
    mix_robust_tables,
    mix_sparse,
    norm_clip_coeffs,
    per_experiment,
    plane_norms,
    sparse_offsets,
)
from repro_torch.core.strategies import AggregationStrategy, mixing_matrix
from repro_torch.core.topology import Topology, padded_neighbor_tables
from repro_torch.training.optimizer import Optimizer, apply_updates

__all__ = [
    "DecentralizedConfig",
    "RoundMetrics",
    "DecentralizedTrainer",
    "stack_params",
    "unstack_params",
    "round_coeffs",
    "coeffs_stack",
    "make_mix_fn",
    "sparse_schedule",
    "edges_schedule",
    "make_local_train_fn",
    "make_round_fn",
    "participation_carry_init",
    "make_participation_round_fn",
    "fault_carry_init",
    "make_fault_round_fn",
    "eval_round_indices",
    "node_budget",
    "ranks_per_card",
    "slice_rows",
    "vmap_in_slices",
    "make_scan_fn",
]

MIX_IMPLS = ("einsum", "pallas", "edges", "sparse")


def stack_params(params_list) -> object:
    """[tree] * n  →  stacked tree with leading node axis."""
    return tree_util.tree_map(lambda *xs: torch.stack(xs), *params_list)


def unstack_params(stacked, n: int) -> list:
    """Stacked tree → n per-node trees (views)."""
    return [tree_util.tree_map(lambda x: x[i], stacked) for i in range(n)]


@dataclasses.dataclass(frozen=True)
class DecentralizedConfig:
    rounds: int = 40           # R in the paper
    local_epochs: int = 5      # E in the paper
    eval_every: int = 1
    resample_random_each_round: bool = True   # the Random baseline redraws
    # True: Eq. (2) accumulates in f32 whatever the param dtype; False:
    # in the native param/plane dtype (the low-precision ablation)
    mix_in_float32: bool = True
    unroll_eval: bool = False  # True → run() delegates to run_unrolled()
    mix_impl: str = "einsum"   # "einsum" | "pallas" | "edges" | "sparse"
    # mix_impl="sparse": einsum instead when the support's nonzero ring
    # offsets outnumber its max degree + sparse_slack (sparse_schedule)
    sparse_slack: int = 4
    # Robust aggregation (DESIGN.md §16): "mean" (the paper's Eq. (2)) |
    # "trimmed" (coordinate-wise trimmed mean, robust_trim cut per side) |
    # "median" (coordinate-wise median) | "norm_clip" (each neighbour's
    # weight scaled so its row norm is at most robust_clip × the
    # receiver's own; composes with every mix_impl).  "trimmed"/"median"
    # run on mix_impl="einsum" (plain version) or "edges" (CUDA kernel).
    robust: str = "mean"
    robust_trim: int = 1
    robust_clip: float = 1.0
    # True: the pipeline supplies E distinct epoch passes per round
    # (NodeBatcher(local_epochs=E)); False: one epoch tiled E times
    epoch_shuffle: bool = True


@dataclasses.dataclass
class RoundMetrics:
    round: int
    iid_acc: np.ndarray   # (n,) per-node accuracy on test_iid
    ood_acc: np.ndarray   # (n,) per-node accuracy on test_ood
    train_loss: np.ndarray  # (n,)


# ----------------------------------------------------------------------
# mixing-matrix schedules
# ----------------------------------------------------------------------
def round_coeffs(topo: Topology, strategy: AggregationStrategy,
                 round_idx: int, data_counts: Optional[np.ndarray] = None,
                 coeffs_fn: Optional[Callable[[int], np.ndarray]] = None,
                 resample_random: bool = True) -> np.ndarray:
    """(n, n) f32 mixing matrix for one round, as the reference builds
    it: ``coeffs_fn(round_idx)`` when given, else the f32 coefficient
    program for its kinds (``random`` redraws each round unless
    ``resample_random`` is False), else the float64 host matrix cast to
    f32 (the reference runs with x64 off, so its matrix reaches the mix
    as f32)."""
    if coeffs_fn is not None:
        return np.asarray(coeffs_fn(round_idx), dtype=np.float32)
    if strategy.kind in PROGRAM_KINDS:
        program, state = program_for(topo, strategy, data_counts=data_counts,
                                     resample_random=resample_random)
        return program.materialize(
            state, round_indices=np.array([round_idx]))[0]
    return mixing_matrix(topo, strategy, data_counts).astype(np.float32)


def coeffs_stack(topo: Topology, strategy: AggregationStrategy, rounds: int,
                 data_counts: Optional[np.ndarray] = None,
                 coeffs_fn: Optional[Callable[[int], np.ndarray]] = None,
                 resample_random: bool = True) -> np.ndarray:
    """(R, n, n) f32 stack of per-round mixing matrices."""
    if coeffs_fn is None and strategy.kind in PROGRAM_KINDS:
        program, state = program_for(topo, strategy, data_counts=data_counts,
                                     resample_random=resample_random)
        return program.materialize(state, rounds)
    return np.stack([round_coeffs(topo, strategy, r, data_counts, coeffs_fn,
                                  resample_random)
                     for r in range(rounds)])


# ----------------------------------------------------------------------
# round-step factories
# ----------------------------------------------------------------------
def sparse_schedule(mix_support, sparse_slack: int = 4):
    """``(offsets, covered)`` of the circulant schedule for a support
    mask, or ``(None, None)`` when the dense fallback applies: more
    nonzero ring offsets than the support's max degree + ``sparse_slack``.
    ``covered`` is the (n, n) bool mask of the positions the offsets
    reach."""
    support = np.asarray(mix_support)
    n = support.shape[0]
    offsets = sparse_offsets(support)
    off_diag = support * (1.0 - np.eye(n))
    max_degree = int(off_diag.sum(axis=1).max())
    nonzero_offsets = len(offsets) - (1 if 0 in offsets else 0)
    if nonzero_offsets > max_degree + sparse_slack:
        return None, None
    rows = np.arange(n)
    covered = np.zeros((n, n), bool)
    for k in offsets:
        covered[rows, (rows + k) % n] = True
    return offsets, covered


def edges_schedule(mix_support) -> Tuple[np.ndarray, np.ndarray]:
    """``(nbr_idx, nbr_mask)`` padded-ELL tables for a support mask with
    the diagonal forced in (every node keeps a self-slot)."""
    support = np.asarray(mix_support)
    return padded_neighbor_tables(np.maximum(support, np.eye(support.shape[0])))


def _edge_tables(mix_support, device):
    nbr_idx, nbr_mask = edges_schedule(mix_support)
    dev = resolve_device(device)
    return (torch.as_tensor(nbr_idx, dtype=torch.int32, device=dev),
            torch.as_tensor(nbr_mask, device=dev))


def make_mix_fn(mix_impl: str = "einsum",
                mix_support: Optional[np.ndarray] = None,
                sparse_slack: int = 4,
                mix_in_float32: bool = True,
                robust: str = "mean",
                robust_trim: int = 1,
                robust_clip: float = 1.0,
                device=None) -> Callable:
    """Aggregation backend ``(params, coeffs) -> params``.

    ``"edges"`` needs ``mix_support`` — the (n, n) neighbourhood mask
    (adjacency + self-loops) that fixes the padded-ELL tables, placed on
    ``device``; coefficients outside the tables would be dropped.
    ``"sparse"`` needs it too, to fix the ring offsets, and returns the
    einsum backend where :func:`sparse_schedule` falls back.

    ``robust`` (as the reference's ``make_mix_fn``): ``"mean"`` returns
    the plain backends; ``"trimmed"``/``"median"`` need ``mix_support``
    and run on ``"einsum"`` (``mix_robust_tables``) or ``"edges"`` (the
    robust CUDA kernel), any other impl raises; ``"norm_clip"`` puts
    :func:`core.mixing.norm_clip_coeffs` in front of any backend.

    Every backend also takes a sweep's batched operands — trees of ``(E,
    n, ...)`` leaves with ``(E, n, n)`` coefficients — and gives each
    experiment what its own call would; the kernels mix the whole grid in
    one launch."""
    if robust not in ROBUST_MODES:
        raise ValueError(f"unknown robust mode {robust!r}; "
                         f"have {ROBUST_MODES}")
    if robust in ("trimmed", "median"):
        if mix_impl not in ("einsum", "edges"):
            raise ValueError(
                f"robust={robust!r} has no mix_impl={mix_impl!r} path — "
                f"the per-coordinate sort runs over padded neighbour "
                f"tables; use mix_impl='einsum' (plain version) or "
                f"'edges' (CUDA kernel)")
        if mix_support is None:
            raise ValueError(
                f"robust={robust!r} needs mix_support (the (n, n) "
                f"neighbourhood mask, adjacency + self-loops) to fix the "
                f"padded-ELL neighbour tables")
        idx, msk = _edge_tables(mix_support, device)
        trim_k = int(robust_trim) if robust == "trimmed" else 0
        if mix_impl == "einsum":
            return lambda params, coeffs: mix_robust_tables(
                params, coeffs, idx, msk, robust, trim_k=trim_k,
                mix_in_float32=mix_in_float32)
        from repro_torch.kernels.gossip_mix import mix_robust_kernel

        return lambda params, coeffs: mix_robust_kernel(
            params, coeffs, idx, msk, op=robust, trim_k=trim_k,
            mix_in_float32=mix_in_float32)
    if robust == "norm_clip":
        base = make_mix_fn(mix_impl, mix_support=mix_support,
                           sparse_slack=sparse_slack,
                           mix_in_float32=mix_in_float32, device=device)
        clip = float(robust_clip)
        return lambda params, coeffs: base(
            params, norm_clip_coeffs(
                coeffs, plane_norms(params, coeffs.ndim - 1), clip))
    if mix_impl == "einsum":
        return functools.partial(mix_dense, mix_in_float32=mix_in_float32)
    if mix_impl == "pallas":
        from repro_torch.kernels.gossip_mix import mix_plane

        return functools.partial(mix_plane, mix_in_float32=mix_in_float32)
    if mix_impl == "edges":
        if mix_support is None:
            raise ValueError(
                "mix_impl='edges' needs mix_support (the (n, n) "
                "neighbourhood mask, adjacency + self-loops) to fix the "
                "padded-ELL neighbour tables")
        from repro_torch.kernels.gossip_mix import mix_edges_kernel

        idx, msk = _edge_tables(mix_support, device)
        return lambda params, coeffs: mix_edges_kernel(
            params, coeffs, idx, msk, mix_in_float32=mix_in_float32)
    if mix_impl == "sparse":
        if mix_support is None:
            raise ValueError(
                "mix_impl='sparse' needs mix_support (the (n, n) "
                "neighbourhood mask, adjacency + self-loops) to fix the "
                "ring-offset schedule")
        offsets, _ = sparse_schedule(mix_support, sparse_slack)
        if offsets is None:
            return make_mix_fn("einsum", mix_in_float32=mix_in_float32)
        def sparse(params, coeffs):
            if coeffs.ndim == 3:
                return per_experiment(sparse, params, coeffs)
            return mix_sparse(params, coeffs, offsets,
                              mix_in_float32=mix_in_float32)

        return sparse
    raise KeyError(f"unknown mix_impl {mix_impl!r}; have {MIX_IMPLS}")


# ----------------------------------------------------------------------
# vmapped calls in slices of the node axis
# ----------------------------------------------------------------------
def ranks_per_card(device) -> int:
    """How many of this host's ranks share ``device``'s card: local ranks
    go to cards round-robin (``LOCAL_RANK % device_count``,
    ``launch.mesh.init_distributed``), ``LOCAL_WORLD_SIZE`` of them (1
    outside ``torchrun``)."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    cards = torch.cuda.device_count()
    index = torch.device(device).index or 0
    return max(1, len(range(index, local_world, cards)))


def node_budget(device) -> Optional[int]:
    """Bytes one vmapped call over the node axis (a LocalTrain step's
    gradients, an evaluation) may hold: half of this rank's share of the
    card's memory (the card over :func:`ranks_per_card`) that the run's
    tensors do not hold at the time of the call (the caching allocator's
    count of this process, read on the host: no sync), so a grid's
    resident params, optimizer state and batches shrink it; no limit on
    the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        share = total // ranks_per_card(device)
        return max(0, share - torch.cuda.memory_allocated(device)) // 2
    return None


def slice_rows(fn: Callable, node_batch, rows: int,
               budget: Optional[int], unit: int = 1) -> int:
    """How many of ``rows`` nodes one vmapped call of ``fn`` takes: all of
    them, unless ``fn`` states ``working_bytes(node_batch)``, the bytes
    one node's call holds at once (``models.paper_models.lm_loss`` and
    ``lm_accuracy`` do: GPT-2's einsum attention holds ``(b, H, S, S)``
    scores a node), and ``rows`` of them exceed ``budget``.  A slice that
    holds ``unit`` nodes (one experiment of a sweep folded into the node
    axis) holds a whole number of units."""
    node_bytes = getattr(fn, "working_bytes", None)
    if node_bytes is None or budget is None:
        return rows
    take = max(1, min(rows, budget // max(1, int(node_bytes(node_batch)))))
    return take - take % unit if take >= unit else take


def vmap_in_slices(vmapped: Callable, params, batch, rows: int,
                   batch_per_node: bool = False):
    """``vmapped(params, batch)`` over slices of ``rows`` nodes of the
    leading axis (of ``batch`` too when ``batch_per_node``), each output
    leaf concatenated: every node's value is computed as in one call.  An
    evaluation keeps its batch whole (an accuracy is a ratio of sums over
    all of it)."""
    n = tree_util.leaves(params)[0].shape[0]
    if rows >= n:
        return vmapped(params, batch)
    cut = lambda t, a: tree_util.tree_map(lambda x: x[a:a + rows], t)
    outs = [vmapped(cut(params, a), cut(batch, a) if batch_per_node
                    else batch) for a in range(0, n, rows)]
    return tree_util.tree_map(lambda *xs: torch.cat(xs), *outs)


def make_local_train_fn(loss_fn: Callable, optimizer: Optimizer,
                        local_epochs: int,
                        epoch_shuffle: bool = True) -> Callable:
    """LocalTrain (Eq. 1) over the stacked node axis:
    ``(params, opt_state, batches) -> (params, opt_state, losses (n,))``
    with batch leaves ``(n, E·steps, batch, ...)``.  ``loss_fn(params,
    batch)`` is written for ONE node and mapped with ``torch.func.vmap``;
    a step's gradients are taken over slices of the node axis that fit
    that step's :func:`node_budget` when ``loss_fn`` states its
    ``working_bytes`` (:func:`slice_rows`), in one call otherwise.  With
    a sweep's ``experiments`` folded into the node axis, a slice that
    holds one experiment holds whole ones, so that each experiment's
    gradients are computed as in its own run.

    ``epoch_shuffle=True``: the batches already carry all E epochs and are
    consumed as-is; ``False`` (legacy): one epoch tiled E times."""
    step_fn = torch.func.vmap(torch.func.grad_and_value(loss_fn))

    def local_train(params, opt_state, batches, experiments: int = 1):
        total = tree_util.leaves(batches)[0].shape[1]
        if epoch_shuffle:
            if total % local_epochs:
                raise ValueError(
                    f"epoch_shuffle=True expects the pipeline to supply "
                    f"local_epochs={local_epochs} distinct epoch passes "
                    f"(NodeBatcher(local_epochs=...)), but the {total}-step "
                    f"batch axis is not divisible by {local_epochs}")
        else:
            batches = tree_util.tree_map(
                lambda x: torch.cat([x] * local_epochs, dim=1), batches)
            total *= local_epochs
        leaf = tree_util.leaves(params)[0]
        one = tree_util.tree_map(lambda x: x[0, 0], batches)
        losses = []
        for s in range(total):
            batch = tree_util.tree_map(lambda x: x[:, s], batches)
            rows = slice_rows(loss_fn, one, leaf.shape[0],
                              node_budget(leaf.device),
                              leaf.shape[0] // experiments)
            grads, loss = vmap_in_slices(step_fn, params, batch, rows,
                                         batch_per_node=True)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            del grads   # held through the next step's gradients otherwise
            params = apply_updates(params, updates)
            del updates
            losses.append(loss)
        return params, opt_state, torch.stack(losses).mean(0)

    return local_train


def _experiments(coeffs) -> Optional[int]:
    """E for a sweep's ``(E, n, n)`` matrices, None for one ``(n, n)``."""
    return coeffs.shape[0] if coeffs.ndim == 3 else None


def _fold(tree, e: Optional[int]):
    """``(E, n, ...)`` leaves as ``(E·n, ...)`` (views)."""
    if e is None:
        return tree
    return tree_util.tree_map(lambda x: x.reshape((-1,) + x.shape[2:]), tree)


def _unfold(tree, e: Optional[int]):
    if e is None:
        return tree
    return tree_util.tree_map(lambda x: x.reshape((e, -1) + x.shape[1:]),
                              tree)


def _local_train_folded(local_train, params, opt, batches, e):
    """LocalTrain with a sweep's E experiments folded into the node axis."""
    p, o, losses = local_train(_fold(params, e), _fold(opt, e),
                               _fold(batches, e), e or 1)
    return _unfold(p, e), _unfold(o, e), _unfold(losses, e)


def make_round_fn(loss_fn: Callable, optimizer: Optimizer, local_epochs: int,
                  mix_impl: str = "einsum",
                  epoch_shuffle: bool = True,
                  mix_support: Optional[np.ndarray] = None,
                  sparse_slack: int = 4,
                  mix_in_float32: bool = True,
                  robust: str = "mean",
                  robust_trim: int = 1,
                  robust_clip: float = 1.0,
                  device=None) -> Callable:
    """One full round — LocalTrain on every node, then aggregation —
    ``(params, opt, node_batches, coeffs) -> (mixed params, opt, losses)``."""
    local_train = make_local_train_fn(loss_fn, optimizer, local_epochs,
                                      epoch_shuffle)
    mix = make_mix_fn(mix_impl, mix_support=mix_support,
                      sparse_slack=sparse_slack,
                      mix_in_float32=mix_in_float32, robust=robust,
                      robust_trim=robust_trim, robust_clip=robust_clip,
                      device=device)

    def round_fn(stacked_params, stacked_opt, node_batches, coeffs):
        params, opt, losses = _local_train_folded(
            local_train, stacked_params, stacked_opt, node_batches,
            _experiments(coeffs))
        return mix(params, coeffs), opt, losses

    return round_fn


def _select(mask: torch.Tensor, new, old):
    """Per node: ``new`` rows where ``mask`` ((n,), or (E, n) for a
    sweep's trees) is set, else ``old`` (every leaf, optimizer steps
    included, carries the node axis)."""
    def sel(a, b):
        return torch.where(
            mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim)), a, b)
    return tree_util.tree_map(sel, new, old)


def _node_shape(params, rate) -> tuple:
    """``(n,)``, or ``(E, n)`` when the rate is one per experiment."""
    leaf = tree_util.leaves(params)[0]
    return tuple(leaf.shape[:1 + np.ndim(rate)])


def _host_scalars(rate, seed):
    """A carry's rate (f32) and seed: host scalars, or ``(E,)`` arrays."""
    if np.ndim(rate) == 0:
        return np.float32(rate), int(seed)
    rate = np.asarray(rate, np.float32)
    return rate, np.broadcast_to(np.asarray(seed, np.int64), rate.shape)


def participation_carry_init(params, rate, pseed) -> dict:
    """Per-run participation carry (the reference's, DESIGN.md §15):
    ``rate``/``pseed`` (host scalars, or ``(E,)`` arrays for a sweep's
    ``(E, n, ...)`` trees), ``pub`` — the published plane, a copy of the
    initial params — and per-node int32 counters ``staleness``,
    ``staleness_sum``, ``rounds_active``, ``local_steps`` on the params'
    device."""
    leaf = tree_util.leaves(params)[0]
    zeros = torch.zeros(_node_shape(params, rate), dtype=torch.int32,
                        device=leaf.device)
    rate, pseed = _host_scalars(rate, pseed)
    return {
        "rate": rate,
        "pseed": pseed,
        "pub": tree_util.tree_map(lambda x: x.clone(), params),
        "staleness": zeros,
        "staleness_sum": zeros,
        "rounds_active": zeros,
        "local_steps": zeros,
    }


def _participation_update(pcarry, active, steps):
    act = active.to(torch.int32)
    staleness = torch.where(active, 0, pcarry["staleness"] + 1)
    return {
        **pcarry,
        "staleness": staleness,
        "staleness_sum": pcarry["staleness_sum"] + staleness,
        "rounds_active": pcarry["rounds_active"] + act,
        "local_steps": pcarry["local_steps"] + act * steps,
    }


def make_participation_round_fn(loss_fn: Callable, optimizer: Optimizer,
                                local_epochs: int, participation,
                                mix_impl: str = "einsum",
                                epoch_shuffle: bool = True,
                                mix_support: Optional[np.ndarray] = None,
                                sparse_slack: int = 4,
                                mix_in_float32: bool = True,
                                robust: str = "mean",
                                robust_trim: int = 1,
                                robust_clip: float = 1.0,
                                device=None) -> Callable:
    """Partial-participation round (the reference's, DESIGN.md §15):
    ``(params, opt, pcarry, node_batches, coeffs, round_idx) -> (params,
    opt, pcarry, losses)``.  The mix arguments are :func:`make_mix_fn`'s.

    Every node trains (inactive results are discarded); active nodes
    publish their fresh rows into ``pcarry["pub"]``; the published plane
    is mixed (stale rows of inactive neighbours, or, with
    ``stale_mixing=False``, their columns dropped and rows renormalised);
    active rows take the mix and the fresh optimizer state, inactive rows
    keep theirs and report loss 0.  ``rate=1.0`` activates every node, so
    such a run is bit-identical to :func:`make_round_fn`."""
    local_train = make_local_train_fn(loss_fn, optimizer, local_epochs,
                                      epoch_shuffle)
    mix = make_mix_fn(mix_impl, mix_support=mix_support,
                      sparse_slack=sparse_slack,
                      mix_in_float32=mix_in_float32, robust=robust,
                      robust_trim=robust_trim, robust_clip=robust_clip,
                      device=device)

    def round_fn(stacked_params, stacked_opt, pcarry, node_batches, coeffs,
                 round_idx):
        e = _experiments(coeffs)
        trained, opt_t, losses = _local_train_folded(
            local_train, stacked_params, stacked_opt, node_batches, e)
        n = losses.shape[-1]
        steps = tree_util.leaves(node_batches)[0].shape[losses.ndim]
        active = to_device(participation.active_mask(
            pcarry["rate"], pcarry["pseed"], round_idx, n), losses.device)
        pub = _select(active, trained, pcarry["pub"])
        if not participation.stale_mixing:
            coeffs = participation_renormalize(coeffs, active)
        params = _select(active, mix(pub, coeffs), stacked_params)
        opt = _select(active, opt_t, stacked_opt)
        losses = torch.where(active, losses, torch.zeros_like(losses))
        pcarry = _participation_update({**pcarry, "pub": pub}, active, steps)
        return params, opt, pcarry, losses

    return round_fn


def fault_carry_init(params, rate, fseed) -> dict:
    """Per-run fault/quarantine carry (the reference's, DESIGN.md §16):
    ``rate``/``fseed`` (host scalars, or ``(E,)`` arrays for a sweep's
    ``(E, n, ...)`` trees); per node on the params' device:
    ``qtimer`` (probation countdown, quarantined while > 0), ``norm_ema``
    (EMA of the published row norm, 0 = not seeded yet),
    ``rounds_quarantined``, ``fault_rounds``, ``quar_fault_rounds``, and
    ``first_fault``/``first_quar`` (first such round, −1 = never)."""
    shape = _node_shape(params, rate)
    dev = tree_util.leaves(params)[0].device
    zeros = torch.zeros(shape, dtype=torch.int32, device=dev)
    never = torch.full(shape, -1, dtype=torch.int32, device=dev)
    rate, fseed = _host_scalars(rate, fseed)
    return {
        "rate": rate,
        "fseed": fseed,
        "qtimer": zeros,
        "norm_ema": torch.zeros(shape, dtype=torch.float32, device=dev),
        "rounds_quarantined": zeros,
        "fault_rounds": zeros,
        "quar_fault_rounds": zeros,
        "first_fault": never,
        "first_quar": never,
    }


def _quarantine_screen(fault, fcarry, pub, faulty, round_idx):
    """The reference's health screen: flag rows with a nonfinite value or
    a norm above ``spike_ratio`` × their EMA, (re)start their probation,
    advance the EMA of the rows that passed, and count.  Returns the
    updated carry and the (n,) quarantined mask."""
    lead = faulty.ndim
    norms = plane_norms(pub, lead)
    nonfinite = sum(
        (~torch.isfinite(leaf.reshape(tuple(leaf.shape[:lead]) + (-1,))))
        .sum(dim=-1, dtype=torch.int32)
        for leaf in tree_util.leaves(pub))
    ema = fcarry["norm_ema"]
    suspicious = ((nonfinite > 0) | ~torch.isfinite(norms)
                  | ((ema > 0.0) & (norms > fault.spike_ratio * ema)))
    qtimer = torch.where(suspicious, fault.probation,
                         torch.clamp_min(fcarry["qtimer"] - 1, 0))
    quarantined = qtimer > 0
    # the EMA moves only on rounds the node passes the screen
    healthy = torch.where(
        ema > 0.0, fault.ema_beta * ema + (1.0 - fault.ema_beta) * norms,
        norms)
    qint = quarantined.to(torch.int32)
    fcarry = {
        **fcarry,
        "norm_ema": torch.where(suspicious, ema, healthy),
        "qtimer": qtimer.to(torch.int32),
        "rounds_quarantined": fcarry["rounds_quarantined"] + qint,
        "quar_fault_rounds": (fcarry["quar_fault_rounds"]
                              + qint * faulty.to(torch.int32)),
        "first_quar": torch.where((fcarry["first_quar"] < 0) & quarantined,
                                  round_idx, fcarry["first_quar"]),
    }
    return fcarry, quarantined


def make_fault_round_fn(loss_fn: Callable, optimizer: Optimizer,
                        local_epochs: int, fault, participation=None,
                        mix_impl: str = "einsum",
                        epoch_shuffle: bool = True,
                        mix_support: Optional[np.ndarray] = None,
                        sparse_slack: int = 4,
                        mix_in_float32: bool = True,
                        robust: str = "mean",
                        robust_trim: int = 1,
                        robust_clip: float = 1.0,
                        device=None) -> Callable:
    """Byzantine-fault round (the reference's, DESIGN.md §16).  Without
    participation: ``(params, opt, fcarry, node_batches, coeffs,
    round_idx) -> (params, opt, fcarry, losses)``; with a
    ``ParticipationSpec`` the participation carry comes before the fault
    carry on both sides.  The mix arguments are :func:`make_mix_fn`'s.

    Per round: LocalTrain every node, publish (through the stale plane
    with participation), draw the faulty set (``fault.faulty_mask``, fold
    index 3) and overwrite faulty nodes' PUBLISHED rows with
    ``fault.corrupt`` garbage; a faulty node keeps its own trained
    params.  With ``fault.quarantine`` the screen flags rows, excises
    their columns from the matrix (``quarantine_renormalize``) and zeroes
    their plane rows BEFORE the mix, since 0 × NaN would re-poison every
    destination; quarantined nodes keep training locally.

    ``rate=0.0`` draws no faulty node and every select keeps the clean
    branch, so a zero-fault run is bit-identical to :func:`make_round_fn`
    (:func:`make_participation_round_fn` with participation)."""
    local_train = make_local_train_fn(loss_fn, optimizer, local_epochs,
                                      epoch_shuffle)
    mix = make_mix_fn(mix_impl, mix_support=mix_support,
                      sparse_slack=sparse_slack,
                      mix_in_float32=mix_in_float32, robust=robust,
                      robust_trim=robust_trim, robust_clip=robust_clip,
                      device=device)

    def round_fn(stacked_params, stacked_opt, *state_and_xs):
        if participation is not None:
            pcarry, fcarry, node_batches, coeffs, round_idx = state_and_xs
        else:
            pcarry = None
            fcarry, node_batches, coeffs, round_idx = state_and_xs
        e = _experiments(coeffs)
        trained, opt_t, losses = _local_train_folded(
            local_train, stacked_params, stacked_opt, node_batches, e)
        n, dev = losses.shape[-1], losses.device
        if participation is not None:
            active = to_device(participation.active_mask(
                pcarry["rate"], pcarry["pseed"], round_idx, n), dev)
            pub = _select(active, trained, pcarry["pub"])
            if not participation.stale_mixing:
                coeffs = participation_renormalize(coeffs, active)
        else:
            pub = trained
        faulty_host = fault.faulty_mask(fcarry["rate"], fcarry["fseed"],
                                        round_idx, n)
        faulty = to_device(faulty_host, dev)
        # the corruption lands on the PUBLISHED plane (and stays in
        # pcarry["pub"] until the node publishes again)
        pub = _select(faulty, fault.corrupt(pub, fcarry["fseed"], round_idx,
                                            faulty_host), pub)
        fcarry = {
            **fcarry,
            "fault_rounds": fcarry["fault_rounds"] + faulty.to(torch.int32),
            "first_fault": torch.where(
                (fcarry["first_fault"] < 0) & faulty, round_idx,
                fcarry["first_fault"]),
        }
        if fault.quarantine:
            fcarry, quarantined = _quarantine_screen(fault, fcarry, pub,
                                                     faulty, round_idx)
            coeffs = quarantine_renormalize(coeffs, quarantined)
            pub_mix = _select(quarantined,
                              tree_util.tree_map(torch.zeros_like, pub), pub)
            keep_local = faulty | quarantined
        else:
            pub_mix, keep_local = pub, faulty
        params = _select(keep_local, trained, mix(pub_mix, coeffs))
        if participation is None:
            return params, opt_t, fcarry, losses
        params = _select(active, params, stacked_params)
        opt = _select(active, opt_t, stacked_opt)
        losses = torch.where(active, losses, torch.zeros_like(losses))
        steps = tree_util.leaves(node_batches)[0].shape[losses.ndim]
        pcarry = _participation_update({**pcarry, "pub": pub}, active, steps)
        return params, opt, pcarry, fcarry, losses

    return round_fn


def make_scan_fn(round_fn: Callable, evaluate: Callable,
                 make_batch: Optional[Callable] = None,
                 coeff_fn: Optional[Callable] = None,
                 analytics=None,
                 keep_history: bool = True,
                 participation=None,
                 fault=None) -> Callable:
    """The round loop shared by the sweep engine's modes (the reference's
    ``lax.scan`` over rounds, here a Python loop with the same argument
    and return order).

    ``round_fn`` has :func:`make_round_fn`'s signature, or with
    ``participation`` :func:`make_participation_round_fn`'s, with
    ``fault`` :func:`make_fault_round_fn`'s (the participation carry
    before the fault carry); ``evaluate(params, test_iid, test_ood) ->
    (iid, ood)``; ``make_batch`` maps a step's slice of ``batch_xs`` to
    the round's node batches (identity by default: stacked batches).
    ``coeff_fn`` makes ``coeffs`` a sequence of absolute round indices
    whose matrices ``coeff_fn(r)`` computes each step (a coefficient
    program).  ``analytics`` (``core.analytics.AnalyticsSpec``) folds
    every eval round into its carry; ``keep_history=False`` (needs
    ``analytics``) returns no per-round history.

    Returns ``scan_fn(params, opt, batch_xs, coeffs, eval_mask, test_iid,
    test_ood[, round_idx, analytics_carry, participation_carry,
    fault_carry]) -> (params, opt[, participation_carry][, fault_carry]
    [, analytics_carry][, losses, iid, ood])``.  ``batch_xs`` and
    ``coeffs`` are indexed by the step (leading axis R, or a tree of
    such), ``eval_mask`` and ``round_idx`` are host sequences (the
    absolute round indices that analytics, participation and fault draws
    fold, so a chunk cannot shift them).  The eval runs only where
    ``eval_mask`` is set; other steps report zeros and leave the
    analytics carry as it is.  Nothing in the loop reads a device value
    back: the history stays on the device, stacked on a leading R axis,
    until the caller takes it."""
    if make_batch is None:
        make_batch = lambda b: b
    if not keep_history and analytics is None:
        raise ValueError("keep_history=False without an analytics spec "
                         "would return no metrics at all")
    needs_rounds = (analytics is not None or participation is not None
                    or fault is not None)

    def scan_fn(params, opt, batch_xs, coeffs, eval_mask, test_iid,
                test_ood, round_idx=None, analytics_carry=None,
                participation_carry=None, fault_carry=None):
        if needs_rounds and round_idx is None:
            raise ValueError("analytics, participation and faults need the "
                             "absolute round_idx of each step")
        p, o = params, opt
        pc, fc, ac = participation_carry, fault_carry, analytics_carry
        losses_h, iid_h, ood_h = [], [], []
        for t in range(len(eval_mask)):
            bx = tree_util.tree_map(lambda x: x[t], batch_xs)
            c = coeffs[t]
            if coeff_fn is not None:
                c = coeff_fn(int(c))   # c is this step's absolute round
            r_abs = int(round_idx[t]) if needs_rounds else None
            batch = make_batch(bx)
            if fault is not None:
                if participation is not None:
                    p, o, pc, fc, losses = round_fn(p, o, pc, fc, batch, c,
                                                    r_abs)
                else:
                    p, o, fc, losses = round_fn(p, o, fc, batch, c, r_abs)
            elif participation is not None:
                p, o, pc, losses = round_fn(p, o, pc, batch, c, r_abs)
            else:
                p, o, losses = round_fn(p, o, batch, c)
            del batch   # before the next round's gather, not after it
            do_eval = bool(eval_mask[t])
            if do_eval:
                with torch.no_grad():
                    iid, ood = evaluate(p, test_iid, test_ood)
            else:
                iid = ood = torch.zeros(losses.shape, dtype=torch.float32,
                                        device=losses.device)
            if analytics is not None:
                ac = analytics.update(ac, r_abs, do_eval, iid, ood)
            if keep_history:
                losses_h.append(losses)
                iid_h.append(iid)
                ood_h.append(ood)
        out = [p, o]
        if participation is not None:
            out.append(pc)
        if fault is not None:
            out.append(fc)
        if analytics is not None:
            out.append(ac)
        if keep_history:
            out.extend(torch.stack(h) for h in (losses_h, iid_h, ood_h))
        return tuple(out)

    return scan_fn


def eval_round_indices(rounds: int, eval_every: int) -> List[int]:
    """Rounds at which metrics are recorded (every ``eval_every``-th round
    and always the last)."""
    return [r for r in range(rounds)
            if (r + 1) % eval_every == 0 or r == rounds - 1]


# ----------------------------------------------------------------------
# the trainer
# ----------------------------------------------------------------------
class DecentralizedTrainer:
    """Runs Alg. 1 over a topology with a pluggable aggregation strategy.

    Args:
      topology, strategy: the graph and the mixing-matrix rule.
      optimizer: a ``repro_torch.training.optimizer.Optimizer``.
      loss_fn: ``(params, batch) -> scalar`` for ONE node.
      eval_fn: ``(params, test_batch) -> accuracy`` for ONE node.
      config: round/epoch counts and the mixing backend.
      data_counts: per-node sample counts (the ``weighted`` strategy).
      coeffs_fn: ``round -> (n, n)`` matrix overriding the strategy's
        (e.g. ``core.dynamic.link_failure_schedule`` or a link-failure
        program's rounds); its round-0 support joins the static tables
        of ``"edges"``/``"sparse"``, and later rounds may only shrink it.
      device: where the run happens; ``None`` is the CUDA card, and raises
        when there is none — pass ``"cpu"`` to run on the CPU.
    """

    def __init__(
        self,
        topology: Topology,
        strategy: AggregationStrategy,
        optimizer: Optimizer,
        loss_fn: Callable,
        eval_fn: Callable,
        config: DecentralizedConfig = DecentralizedConfig(),
        data_counts: Optional[np.ndarray] = None,
        coeffs_fn: Optional[Callable[[int], np.ndarray]] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.topology = topology
        self.strategy = strategy
        self.optimizer = optimizer
        self.config = config
        self.data_counts = data_counts
        self.coeffs_fn = coeffs_fn
        mix_support = None
        if (config.mix_impl in ("sparse", "edges")
                or config.robust in ("trimmed", "median")):
            # support = neighbourhoods ∪ the strategy's round-0 support, so
            # kinds with off-neighbourhood weight (fl's dense 1/n) keep
            # their mass in the static tables
            n = topology.n_nodes
            m0 = self._round_coeffs(0)
            mix_support = np.maximum(
                topology.adjacency + np.eye(n),
                (np.abs(np.asarray(m0)) > 1e-12).astype(np.float64))
        self._round_fn = make_round_fn(
            loss_fn, optimizer, config.local_epochs, config.mix_impl,
            config.epoch_shuffle, mix_support=mix_support,
            sparse_slack=config.sparse_slack,
            mix_in_float32=config.mix_in_float32, robust=config.robust,
            robust_trim=config.robust_trim, robust_clip=config.robust_clip,
            device=self.device)
        self._eval_raw = eval_fn
        self._eval_fn = torch.func.vmap(eval_fn, in_dims=(0, None))

    # ------------------------------------------------------------------
    def _round_coeffs(self, r: int) -> np.ndarray:
        return round_coeffs(self.topology, self.strategy, r,
                            self.data_counts, self.coeffs_fn,
                            self.config.resample_random_each_round)

    def coeffs_for_round(self, r: int) -> torch.Tensor:
        """Mixing matrix for round r, on the trainer's device."""
        return torch.as_tensor(self._round_coeffs(r), device=self.device)

    def coeffs_stack(self, rounds: Optional[int] = None) -> np.ndarray:
        """(R, n, n) stack of this run's per-round mixing matrices."""
        return coeffs_stack(
            self.topology, self.strategy,
            self.config.rounds if rounds is None else rounds,
            self.data_counts, self.coeffs_fn,
            self.config.resample_random_each_round)

    def _to_device(self, tree):
        return tree_util.tree_map(
            lambda x: torch.as_tensor(x, device=self.device), tree)

    def evaluate(self, stacked_params, test_iid, test_ood):
        """(iid, ood) per-node accuracies, (n,) each; the node axis in
        slices that fit the node budget (:func:`slice_rows`)."""
        n = tree_util.leaves(stacked_params)[0].shape[0]
        with torch.no_grad():
            return tuple(
                vmap_in_slices(self._eval_fn, stacked_params, test,
                               slice_rows(self._eval_raw, test, n,
                                          node_budget(self.device)))
                for test in (test_iid, test_ood))

    def _loop(self, stacked_params, node_batches_fn, test_iid, test_ood,
              coeffs_fn) -> Tuple[object, List[RoundMetrics]]:
        params = self._to_device(stacked_params)
        test_iid, test_ood = self._to_device(test_iid), self._to_device(test_ood)
        opt = self.optimizer.init(params)
        keep = set(eval_round_indices(self.config.rounds,
                                      self.config.eval_every))
        history: List[RoundMetrics] = []
        for r in range(self.config.rounds):
            batches = self._to_device(node_batches_fn(r))
            params, opt, losses = self._round_fn(params, opt, batches,
                                                 coeffs_fn(r))
            if r in keep:
                iid, ood = self.evaluate(params, test_iid, test_ood)
                history.append(RoundMetrics(
                    round=r, iid_acc=iid.cpu().numpy(),
                    ood_acc=ood.cpu().numpy(),
                    train_loss=losses.detach().cpu().numpy()))
        return params, history

    def run(self, stacked_params, node_batches_fn: Callable[[int], object],
            test_iid, test_ood) -> Tuple[object, List[RoundMetrics]]:
        """Train for R rounds with the whole ``(R, n, n)`` coefficient
        stack computed up front.

        Args:
          stacked_params: tree with leaves (n, ...), moved to the device.
          node_batches_fn: ``round -> tree`` of per-node batch stacks with
            leaves (n, E·steps, batch, ...) (numpy or tensors).
          test_iid / test_ood: shared global test batches.
        """
        if self.config.unroll_eval:
            return self.run_unrolled(stacked_params, node_batches_fn,
                                     test_iid, test_ood)
        coeffs = torch.as_tensor(self.coeffs_stack(), device=self.device)
        return self._loop(stacked_params, node_batches_fn, test_iid,
                          test_ood, lambda r: coeffs[r])

    def run_unrolled(self, stacked_params,
                     node_batches_fn: Callable[[int], object],
                     test_iid, test_ood) -> Tuple[object, List[RoundMetrics]]:
        """The same loop, building each round's matrix as it goes."""
        return self._loop(stacked_params, node_batches_fn, test_iid,
                          test_ood, self.coeffs_for_round)
