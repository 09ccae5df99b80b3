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
     name is kept from the reference so configs carry over) or ``"edges"``
     (the padded edge-list CUDA kernel, ``kernels.gossip_mix.
     mix_edges_kernel``).

:meth:`DecentralizedTrainer.run` and :meth:`run_unrolled` are both a
Python loop over rounds with evaluation only on :func:`eval_round_indices`;
they differ in where the per-round matrices come from (one precomputed
``(R, n, n)`` stack vs one matrix per round) and give the same history.
The ``"sparse"`` circulant backend, robust aggregation, participation and
faults wait for later slices (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_util
from repro_torch.core.coeffs import program_for
from repro_torch.core.mixing import mix_dense
from repro_torch.core.strategies import AggregationStrategy
from repro_torch.core.topology import Topology, padded_neighbor_tables
from repro_torch.training.optimizer import Optimizer, apply_updates

__all__ = [
    "DecentralizedConfig",
    "RoundMetrics",
    "DecentralizedTrainer",
    "stack_params",
    "round_coeffs",
    "coeffs_stack",
    "make_mix_fn",
    "edges_schedule",
    "make_local_train_fn",
    "make_round_fn",
    "eval_round_indices",
]

MIX_IMPLS = ("einsum", "pallas", "edges")


def stack_params(params_list) -> object:
    """[tree] * n  →  stacked tree with leading node axis."""
    return tree_util.tree_map(lambda *xs: torch.stack(xs), *params_list)


@dataclasses.dataclass(frozen=True)
class DecentralizedConfig:
    rounds: int = 40           # R in the paper
    local_epochs: int = 5      # E in the paper
    eval_every: int = 1
    # True: Eq. (2) accumulates in f32 whatever the param dtype; False:
    # in the native param/plane dtype (the low-precision ablation)
    mix_in_float32: bool = True
    unroll_eval: bool = False  # True → run() delegates to run_unrolled()
    mix_impl: str = "einsum"   # "einsum" | "pallas" | "edges"
    robust: str = "mean"       # only the paper's Eq. (2) is ported
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
                 round_idx: int,
                 data_counts: Optional[np.ndarray] = None) -> np.ndarray:
    """(n, n) f32 mixing matrix for one round, from the f32 coefficient
    program as the reference builds it."""
    program, state = program_for(topo, strategy, data_counts=data_counts)
    return program.materialize(state, round_indices=np.array([round_idx]))[0]


def coeffs_stack(topo: Topology, strategy: AggregationStrategy, rounds: int,
                 data_counts: Optional[np.ndarray] = None) -> np.ndarray:
    """(R, n, n) f32 stack of per-round mixing matrices."""
    program, state = program_for(topo, strategy, data_counts=data_counts)
    return program.materialize(state, rounds)


# ----------------------------------------------------------------------
# round-step factories
# ----------------------------------------------------------------------
def edges_schedule(mix_support) -> Tuple[np.ndarray, np.ndarray]:
    """``(nbr_idx, nbr_mask)`` padded-ELL tables for a support mask with
    the diagonal forced in (every node keeps a self-slot)."""
    support = np.asarray(mix_support)
    return padded_neighbor_tables(np.maximum(support, np.eye(support.shape[0])))


def make_mix_fn(mix_impl: str = "einsum",
                mix_support: Optional[np.ndarray] = None,
                mix_in_float32: bool = True,
                robust: str = "mean",
                device=None) -> Callable:
    """Aggregation backend ``(params, coeffs) -> params``.

    ``"edges"`` needs ``mix_support`` — the (n, n) neighbourhood mask
    (adjacency + self-loops) that fixes the padded-ELL tables, placed on
    ``device``; coefficients outside the tables would be dropped."""
    if robust != "mean":
        raise NotImplementedError(
            f"robust={robust!r} is not ported yet (the Byzantine layer, "
            f"ROADMAP Queue 1); the port has robust='mean'")
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

        nbr_idx, nbr_mask = edges_schedule(mix_support)
        dev = resolve_device(device)
        idx = torch.as_tensor(nbr_idx, dtype=torch.int32, device=dev)
        msk = torch.as_tensor(nbr_mask, device=dev)
        return lambda params, coeffs: mix_edges_kernel(
            params, coeffs, idx, msk, mix_in_float32=mix_in_float32)
    if mix_impl == "sparse":
        raise NotImplementedError(
            "mix_impl='sparse' (the circulant schedule) is not ported yet "
            "(ROADMAP Queue 1)")
    raise KeyError(f"unknown mix_impl {mix_impl!r}; have {MIX_IMPLS}")


def make_local_train_fn(loss_fn: Callable, optimizer: Optimizer,
                        local_epochs: int,
                        epoch_shuffle: bool = True) -> Callable:
    """LocalTrain (Eq. 1) over the stacked node axis:
    ``(params, opt_state, batches) -> (params, opt_state, losses (n,))``
    with batch leaves ``(n, E·steps, batch, ...)``.  ``loss_fn(params,
    batch)`` is written for ONE node and mapped with ``torch.func.vmap``.

    ``epoch_shuffle=True``: the batches already carry all E epochs and are
    consumed as-is; ``False`` (legacy): one epoch tiled E times."""
    step_fn = torch.func.vmap(torch.func.grad_and_value(loss_fn))

    def local_train(params, opt_state, batches):
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
        losses = []
        for s in range(total):
            batch = tree_util.tree_map(lambda x: x[:, s], batches)
            grads, loss = step_fn(params, batch)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = apply_updates(params, updates)
            losses.append(loss)
        return params, opt_state, torch.stack(losses).mean(0)

    return local_train


def make_round_fn(loss_fn: Callable, optimizer: Optimizer, local_epochs: int,
                  mix_impl: str = "einsum",
                  epoch_shuffle: bool = True,
                  mix_support: Optional[np.ndarray] = None,
                  mix_in_float32: bool = True,
                  robust: str = "mean",
                  device=None) -> Callable:
    """One full round — LocalTrain on every node, then aggregation —
    ``(params, opt, node_batches, coeffs) -> (mixed params, opt, losses)``."""
    local_train = make_local_train_fn(loss_fn, optimizer, local_epochs,
                                      epoch_shuffle)
    mix = make_mix_fn(mix_impl, mix_support=mix_support,
                      mix_in_float32=mix_in_float32, robust=robust,
                      device=device)

    def round_fn(stacked_params, stacked_opt, node_batches, coeffs):
        params, opt, losses = local_train(stacked_params, stacked_opt,
                                          node_batches)
        return mix(params, coeffs), opt, losses

    return round_fn


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
        device=None,
    ):
        self.device = resolve_device(device)
        self.topology = topology
        self.strategy = strategy
        self.optimizer = optimizer
        self.config = config
        self.data_counts = data_counts
        mix_support = None
        if config.mix_impl == "edges":
            # support = neighbourhoods ∪ the strategy's round-0 support, so
            # kinds with off-neighbourhood weight (fl's dense 1/n) keep
            # their mass in the static tables
            n = topology.n_nodes
            m0 = round_coeffs(topology, strategy, 0, data_counts)
            mix_support = np.maximum(
                topology.adjacency + np.eye(n),
                (np.abs(np.asarray(m0)) > 1e-12).astype(np.float64))
        self._round_fn = make_round_fn(
            loss_fn, optimizer, config.local_epochs, config.mix_impl,
            config.epoch_shuffle, mix_support=mix_support,
            mix_in_float32=config.mix_in_float32, robust=config.robust,
            device=self.device)
        self._eval_fn = torch.func.vmap(eval_fn, in_dims=(0, None))

    # ------------------------------------------------------------------
    def coeffs_for_round(self, r: int) -> torch.Tensor:
        """Mixing matrix for round r, on the trainer's device."""
        return torch.as_tensor(
            round_coeffs(self.topology, self.strategy, r, self.data_counts),
            device=self.device)

    def coeffs_stack(self, rounds: Optional[int] = None) -> np.ndarray:
        """(R, n, n) stack of this run's per-round mixing matrices."""
        return coeffs_stack(
            self.topology, self.strategy,
            self.config.rounds if rounds is None else rounds,
            self.data_counts)

    def _to_device(self, tree):
        return tree_util.tree_map(
            lambda x: torch.as_tensor(x, device=self.device), tree)

    def evaluate(self, stacked_params, test_iid, test_ood):
        """(iid, ood) per-node accuracies, (n,) each."""
        with torch.no_grad():
            return (self._eval_fn(stacked_params, test_iid),
                    self._eval_fn(stacked_params, test_ood))

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
